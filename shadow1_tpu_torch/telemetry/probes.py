"""On-device flow-probe ring — per-window state samples of watched entities
(port of ``telemetry/probes.py``).

``EngineParams.probes`` holds K watched (host, sock) pairs, resolved at
config time (``config/experiment.resolve_watchlist``). A ``[W, K, F]`` i64
tensor rides in ``SimState.probes`` beside the telemetry ring: at the end
of every window the engine gathers each probe's state columns
(``registry.PROBE_FIELDS`` order) — one gather per plane with a [K] index
tensor (``probe_index``, built once per engine), no host read — and
writes the [K, F] row at slot ``window % W``. At chunk boundaries
``drain_probes`` reads the rows back (one device→host copy) as JSONL
``flow`` records; windows overwritten before a drain become one
``flow_gap`` record.

The samples are window-boundary state, so they equal the JAX engine's bit
for bit. Probes default off: ``probe_init`` returns None and the state has
no such leaf. Columns with i32 semantics (the TCP sequence and window
fields) widen through the u32 window (``& 0xFFFFFFFF`` on the i64
widening; torch has no general uint32 arithmetic on CUDA); ``inflight``
is the one signed column (``snd_nxt − snd_una`` in i32, then widened).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch.consts import SEC
from shadow1_tpu_torch.telemetry.registry import (
    PROBE_FIELDS,
    REC_FLOW,
    REC_FLOW_GAP,
)

_COL = {f: i for i, f in enumerate(PROBE_FIELDS)}


class ProbeRing(NamedTuple):
    """The device-resident probe ring: one [K, F] row per window."""

    buf: torch.Tensor  # i64 [W, K, len(PROBE_FIELDS)]


def probe_init(n_windows: int, probes: tuple, device) -> ProbeRing | None:
    """A W-row probe ring for K watched entities, or None when disabled
    (no probes, or no ring depth): no state leaf, the historic layout."""
    if n_windows <= 0 or not probes:
        return None
    return ProbeRing(buf=torch.zeros(
        (int(n_windows), len(probes), len(PROBE_FIELDS)), dtype=torch.int64,
        device=device))


class ProbeIndex(NamedTuple):
    """A watchlist's [K] index tensors on the device, built once per
    engine (``Ctx.probe_index``). One device holds hosts 0..H-1."""

    host: torch.Tensor      # i64, clamped into range
    sock: torch.Tensor      # i64, −1 clamped to 0
    has_sock: torch.Tensor  # bool: a socket view, not the host view
    owned: torch.Tensor     # bool: the host is one of this device's


def probe_index(probes: tuple, n_hosts: int, device) -> ProbeIndex:
    """The index tensors of ``probes`` ((host, sock) pairs)."""
    loc = [gh for gh, _ in probes]
    return ProbeIndex(
        host=torch.tensor([min(max(x, 0), n_hosts - 1) for x in loc],
                          dtype=torch.long, device=device),
        sock=torch.tensor([max(s, 0) for _, s in probes], dtype=torch.long,
                          device=device),
        has_sock=torch.tensor([s >= 0 for _, s in probes], device=device),
        owned=torch.tensor([0 <= x < n_hosts for x in loc], device=device))


def _u32w(v: torch.Tensor) -> torch.Tensor:
    """i32 plane value → i64 through the u32 window."""
    return v.to(torch.int64) & 0xFFFFFFFF


def probe_sample(st, ctx, win_end) -> torch.Tensor:
    """The [K, F] boundary sample of every watched entity of
    ``ctx.probe_index``, at full width (the telem phase's ctx). A socket
    of −1 is the host-only view; a host past the last samples 0 in every
    column."""
    from shadow1_tpu_torch.core.events import tb_join

    dev = st.evbuf.kind.device
    host, sock, has_sock, owned = ctx.probe_index
    k = host.shape[0]
    cols = torch.zeros((len(PROBE_FIELDS), k), dtype=torch.int64, device=dev)
    model = st.model
    mf = getattr(model, "_fields", ())
    if "nic" in mf and "tcp" in mf:
        tcp = model.tcp

        def at(name):
            return tcp[name][sock, host]

        tc = {
            "tcp_state": _u32w(at("st")),
            "cwnd": _u32w(at("cwnd")),
            "ssthresh": _u32w(at("ssthresh")),
            "snd_max": _u32w(at("snd_max")),
            "peer_wnd": _u32w(at("peer_wnd")),
            "inflight": (at("snd_nxt") - at("snd_una")).to(torch.int64),
        }
        for f in ("srtt", "rttvar", "rto"):
            tc[f] = tb_join(at(f + "_hi"), at(f + "_lo"))
        for f, v in tc.items():
            cols[_COL[f]] = torch.where(has_sock, v, 0)
        nic = model.nic
        cols[_COL["nic_tx_backlog_ns"]] = torch.clamp(
            nic.tx_free[host] - win_end, min=0)
        cols[_COL["nic_rx_backlog_ns"]] = torch.clamp(
            nic.rx_free[host] - win_end, min=0)
        cols[_COL["nic_tx_bytes"]] = nic.tx_bytes[host]
        cols[_COL["nic_rx_bytes"]] = nic.rx_bytes[host]
    cols[_COL["pending_events"]] = (st.evbuf.kind[:, host] != 0).sum(
        dim=0, dtype=torch.int64)
    return torch.where(owned[:, None], cols.T, 0)  # [K, F]


def probe_record(pring: ProbeRing, m0, row) -> ProbeRing:
    """The ring with this window's [K, F] row at slot ``m0.windows % W``
    (``m0``: the window-entry Metrics, as ``ring_record``)."""
    slot = (m0.windows % pring.buf.shape[0]).view(1)
    return pring._replace(buf=pring.buf.index_copy(
        0, slot, row[None].to(torch.int64)))


def drain_probes(st, window_ns: int, probes: tuple,
                 start: int = 0) -> list[dict]:
    """The flow rows of windows [start, windows done), as JSONL-ready dicts
    in (window, probe) order (one device→host copy); overwritten windows
    become one ``flow_gap`` record."""
    pring = getattr(st, "probes", None)
    if pring is None:
        return []
    buf = pring.buf.cpu().numpy()
    w = buf.shape[0]
    done = int(st.metrics.windows)
    lo = max(start, done - w)
    recs: list[dict] = []
    if lo > start:
        recs.append({
            "type": REC_FLOW_GAP,
            "windows_lost": lo - start,
            "first_window": start,
            "ring_slots": w,
        })
    for win in range(lo, done):
        rows = buf[win % w]
        t = round((win + 1) * window_ns / SEC, 9)
        for k, (gh, sock) in enumerate(probes):
            rec = {
                "type": REC_FLOW,
                "window": win,
                "sim_time_s": t,
                "host": int(gh),
                "sock": int(sock),
            }
            rec.update({f: int(v) for f, v in zip(PROBE_FIELDS, rows[k])})
            recs.append(rec)
    return recs

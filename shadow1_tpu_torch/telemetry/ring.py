"""On-device per-window telemetry ring (port of ``telemetry/ring.py``).

A ``[W, F]`` i64 tensor (``[E, W, F]`` in a fleet, one ring per lane)
rides in ``SimState.telem``. At the end of every
conservative window the engine writes one row — per-window deltas of the
core counters, the occupancy gauges and the state-digest words, in
``registry.RING_FIELDS`` order — at slot ``window % W``, on the device and
without a host read. ``drain_ring`` reads the rows back (one device→host
copy) and returns them as JSONL records; when more than W windows passed
since the last drain, the overwritten head is reported as one
``ring_gap`` record.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch.consts import SEC
from shadow1_tpu_torch.telemetry.registry import (
    REC_RING,
    REC_RING_GAP,
    RING_COUNTERS,
    RING_DIGESTS,
    RING_FIELDS,
    RING_WORK,
)


class TelemetryRing(NamedTuple):
    buf: torch.Tensor  # i64 [W, len(RING_FIELDS)]


def ring_init(n_windows: int, device, n_exp: int = 0) -> TelemetryRing | None:
    """A W-row ring (one per lane of a fleet), or None when the ring is off
    (W == 0)."""
    if n_windows <= 0:
        return None
    lead = (n_exp,) if n_exp else ()
    return TelemetryRing(buf=torch.zeros(
        lead + (int(n_windows), len(RING_FIELDS)), dtype=torch.int64,
        device=device))


def ring_record(ring: TelemetryRing, m0, m1, ev_fill,
                digests=None, telem_reduce=None) -> TelemetryRing:
    """The ring with this window's row written at slot ``m0.windows % W``.
    ``m0`` / ``m1`` are the Metrics at window entry and end; ``ev_fill`` the
    window-end event-slot fill; ``digests`` the i64 [5] state-digest words
    or None (zeros). In a fleet every one of them is per lane ([E],
    digests [E, 5]) and each lane's row goes to its own ring; the lanes
    run their windows in step, so lane 0's count picks the slot.

    ``telem_reduce(counters, gauges) -> (counters, gauges)`` makes a
    sharded rank's row global (``shard/engine.py``): the counter deltas
    and the digest words (per-rank partial sums of globally keyed hashes)
    are summed over the ranks, the first four gauges maxed;
    ``x2x_max_fill`` is already the same on every rank."""
    dev = ring.buf.device
    counters = [getattr(m1, f) - getattr(m0, f) for f in RING_COUNTERS + RING_WORK]
    gauges = [ev_fill, m1.ev_max_fill, m1.ob_max_fill, m1.compact_max_fill]
    if digests is None:
        digests = torch.zeros(m1.windows.shape + (len(RING_DIGESTS),),
                              dtype=torch.int64, device=dev)
    if telem_reduce is not None:
        n_ctr = len(counters)
        summed, maxed = telem_reduce(torch.cat([torch.stack(counters),
                                                digests]), torch.stack(gauges))
        counters, digests = list(summed[:n_ctr]), summed[n_ctr:]
        gauges = list(maxed)
    vals = torch.stack(counters + gauges + [m1.x2x_max_fill], dim=-1)
    row = torch.cat([vals, digests], dim=-1)
    slot = (m0.windows.reshape(-1)[:1] % ring.buf.shape[-2])
    return ring._replace(buf=ring.buf.index_copy(-2, slot, row.unsqueeze(-2)))


def drain_ring(st, window_ns: int, start: int = 0) -> list[dict]:
    """The ring rows of windows [start, windows done), as JSONL-ready dicts
    in window order (one device→host copy)."""
    ring = getattr(st, "telem", None)
    if ring is None:
        return []
    buf = ring.buf.cpu().numpy()
    w = buf.shape[0]
    done = int(st.metrics.windows)
    lo = max(start, done - w)
    recs: list[dict] = []
    if lo > start:
        recs.append({"type": REC_RING_GAP, "windows_lost": lo - start,
                     "first_window": start, "ring_slots": w})
    for win in range(lo, done):
        rec = {"type": REC_RING, "window": win,
               "sim_time_s": round((win + 1) * window_ns / SEC, 9)}
        rec.update({f: int(v) for f, v in zip(RING_FIELDS, buf[win % w])})
        recs.append(rec)
    return recs

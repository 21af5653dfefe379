"""NIC model: per-host serialization on both directions (port of
``net/nic.py``).

One "link free at" clock per direction per host: a packet of wire length L
departs at ``max(now, tx_free)`` and holds the link ``ceil(8·L / bw)`` ns;
the receive side delays packet processing the same way. Two drop gates,
both off by default: the drop-tail queue bound (``qlen_ns``) on either
direction, and RED AQM on the uplink (``tx_stamp``'s ``aqm``). The RED
pipeline is the reference's u64 Q16 one in int64: every product stays
below 2**63 (``pmax_thr`` ≤ 2**32, the Q16 ratio ≤ 2**16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch import rng
from shadow1_tpu_torch.consts import R_AQM, SEC


class NicState(NamedTuple):
    tx_free: torch.Tensor   # i64 [H] uplink busy until
    rx_free: torch.Tensor   # i64 [H] downlink busy until
    tx_bytes: torch.Tensor  # i64 [H]
    rx_bytes: torch.Tensor  # i64 [H]
    aqm_ctr: torch.Tensor   # i64 [H] uplink enqueue-attempt counter (RED coin)


def nic_init(n_hosts: int, device) -> NicState:
    return NicState(*(torch.zeros(n_hosts, dtype=torch.int64, device=device)
                      for _ in NicState._fields))


def ctx_aqm(ctx):
    """The ``aqm`` argument of ``tx_stamp`` from an engine Ctx (None: off)."""
    if not ctx.has_aqm:
        return None
    return (ctx.key, ctx.hosts, ctx.aqm_min_ns, ctx.aqm_span_ns,
            ctx.aqm_pmax_thr)


_RED_CERTAIN = 1 << 32  # the threshold meaning "always"


def ser_delay(wire_bytes, bw_bits):
    """ceil(8e9 · bytes / bw) ns, in integers."""
    w = torch.as_tensor(wire_bytes).to(torch.int64)
    return (w * (8 * SEC) + bw_bits - 1) // bw_bits


def tx_stamp(nic: NicState, mask, wire_bytes, now, bw_up, qlen_ns=None,
             aqm=None):
    """Reserve the uplink: returns (nic', depart_time[H], ok[H], red[H]).

    Two drop gates, in order:

    * **RED early drop** (``aqm`` from ``ctx_aqm``): with backlog q the
      drop probability ramps linearly from 0 to pmax over [min, min + span)
      and is 1 from min + span on. The coin is ``rng.bits`` at (R_AQM,
      host, the host's attempt counter), and the counter advances on every
      masked attempt, dropped or not;
    * **drop-tail** (``qlen_ns``, the bound as serialization backlog): a
      packet is dropped (ok False, link not reserved) when the backlog
      already exceeds the bound.
    """
    red = torch.zeros_like(mask)
    now = torch.as_tensor(now).to(torch.int64)
    if aqm is not None:
        key, hosts, min_ns, span_ns, pmax_thr = aqm
        coin = rng.bits(key, R_AQM, hosts, nic.aqm_ctr)
        nic = nic._replace(aqm_ctr=nic.aqm_ctr + mask.to(torch.int64))
        backlog = torch.clamp(nic.tx_free - now, min=0)
        delta = torch.minimum(torch.clamp(backlog - min_ns, min=0), span_ns)
        ratio_q16 = (delta << 16) // span_ns
        thr = (pmax_thr * ratio_q16) >> 16
        thr = torch.where(delta >= span_ns, _RED_CERTAIN, thr)
        thr = torch.where(pmax_thr > 0, thr, 0)
        red = mask & rng.uniform_lt(coin, thr)
        mask = mask & ~red
    if qlen_ns is not None:
        mask = mask & ((nic.tx_free - now) <= qlen_ns)
    depart = torch.maximum(now, nic.tx_free)
    busy = depart + ser_delay(wire_bytes, bw_up)
    w = torch.as_tensor(wire_bytes).to(torch.int64)
    return (
        nic._replace(tx_free=torch.where(mask, busy, nic.tx_free),
                     tx_bytes=nic.tx_bytes + torch.where(mask, w, 0)),
        depart, mask, red,
    )


def rx_stamp(nic: NicState, mask, wire_bytes, now, bw_dn, qlen_ns=None):
    """Reserve the downlink: returns (nic', ready_time[H], ok[H]) — the
    time the packet clears the receive queue; drop-tail like tx_stamp."""
    now = torch.as_tensor(now).to(torch.int64)
    if qlen_ns is not None:
        mask = mask & ((nic.rx_free - now) <= qlen_ns)
    ready = torch.maximum(now, nic.rx_free)
    busy = ready + ser_delay(wire_bytes, bw_dn)
    w = torch.as_tensor(wire_bytes).to(torch.int64)
    return (
        nic._replace(rx_free=torch.where(mask, busy, nic.rx_free),
                     rx_bytes=nic.rx_bytes + torch.where(mask, w, 0)),
        ready, mask,
    )

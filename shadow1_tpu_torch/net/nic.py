"""NIC model: per-host serialization on both directions (port of
``net/nic.py``).

One "link free at" clock per direction per host: a packet of wire length L
departs at ``max(now, tx_free)`` and holds the link ``ceil(8·L / bw)`` ns;
the receive side delays packet processing the same way. The drop-tail
queue bound (``qlen_ns``) is ported; RED AQM (``tx_stamp``'s ``aqm``, a u64
Q16 pipeline) is not — ``core/engine.py check_supported`` refuses it, and
``aqm_ctr`` stays 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch.consts import SEC


class NicState(NamedTuple):
    tx_free: torch.Tensor   # i64 [H] uplink busy until
    rx_free: torch.Tensor   # i64 [H] downlink busy until
    tx_bytes: torch.Tensor  # i64 [H]
    rx_bytes: torch.Tensor  # i64 [H]
    aqm_ctr: torch.Tensor   # i64 [H] uplink enqueue-attempt counter (RED coin)


def nic_init(n_hosts: int, device) -> NicState:
    return NicState(*(torch.zeros(n_hosts, dtype=torch.int64, device=device)
                      for _ in NicState._fields))


def ser_delay(wire_bytes, bw_bits):
    """ceil(8e9 · bytes / bw) ns, in integers."""
    w = torch.as_tensor(wire_bytes).to(torch.int64)
    return (w * (8 * SEC) + bw_bits - 1) // bw_bits


def tx_stamp(nic: NicState, mask, wire_bytes, now, bw_up, qlen_ns=None):
    """Reserve the uplink: returns (nic', depart_time[H], ok[H], red[H]).
    With ``qlen_ns`` (the queue bound as serialization backlog) a packet
    is dropped (ok False, link not reserved) when the backlog already
    exceeds it. ``red`` (RED early drops) is all False: AQM is not
    ported."""
    red = torch.zeros_like(mask)
    now = torch.as_tensor(now).to(torch.int64)
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

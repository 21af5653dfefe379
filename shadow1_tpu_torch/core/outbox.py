"""Per-host per-window packet outboxes (port of ``core/outbox.py``).

Conservative windows guarantee every cross-host event lands at least one
window ahead, so the engine buffers a window's sends here and routes and
delivers them once, at window end. Layout ``[P, H]`` (payload
``[NP, P, H]``), all planes i32: departure times ride the (hi, lo) split of
``events.tb_split``; ``ctr`` holds the low 32 bits of the i64 lifetime
``pkt_ctr``.

``outbox_append`` has a hand-written CUDA kernel (``core/popk.py``); this
module holds its plain PyTorch version, ``outbox_append_plain``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch.consts import NP
from shadow1_tpu_torch.core.dense import set_col
from shadow1_tpu_torch.core.events import tb_join, tb_split


class Outbox(NamedTuple):
    dst: torch.Tensor        # i32 [P, H]
    kind: torch.Tensor       # i32 [P, H] event kind to deliver at dst
    depart_hi: torch.Tensor  # i32 [P, H] src-NIC departure time, high word
    depart_lo: torch.Tensor  # i32 [P, H] low word (sign-flipped; tb_split)
    ctr: torch.Tensor        # i32 [P, H] per-src packet counter (low word)
    p: torch.Tensor          # i32 [NP, P, H]
    cnt: torch.Tensor        # i32 [H] entries used this window
    pkt_ctr: torch.Tensor    # i64 [H] lifetime per-src packet counter

    def abs_depart(self) -> torch.Tensor:
        """i64 [P, H] departure times (window-granularity readers only)."""
        return tb_join(self.depart_hi, self.depart_lo)


def outbox_init(n_hosts: int, cap: int, device) -> Outbox:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return Outbox(
        dst=z(cap, n_hosts), kind=z(cap, n_hosts), depart_hi=z(cap, n_hosts),
        depart_lo=z(cap, n_hosts), ctr=z(cap, n_hosts), p=z(NP, cap, n_hosts),
        cnt=z(n_hosts),
        pkt_ctr=torch.zeros(n_hosts, dtype=torch.int64, device=device),
    )


def outbox_space(ob: Outbox) -> torch.Tensor:
    """Free slots per host this window, i32 [H]."""
    return ob.dst.shape[0] - ob.cnt


def outbox_fill(ob: Outbox) -> torch.Tensor:
    """Occupancy gauge: this window's fill on the busiest host, i64 scalar."""
    return ob.cnt.amax().to(torch.int64)


def outbox_append_plain(ob: Outbox, mask, dst, kind, depart, p) -> tuple[Outbox, torch.Tensor]:
    """Append one packet per host where ``mask`` at slot ``cnt[h]``.
    Returns (ob, ok_mask); a full outbox drops the packet (ok False).
    ``dst``, ``kind`` and ``depart`` are [H] or 0-d; ``p`` is [NP, H]."""
    cap, h = ob.dst.shape
    ok = mask & (ob.cnt < cap)
    dhi, dlo = tb_split(depart.to(torch.int64).expand(h))
    ob = ob._replace(
        dst=set_col(ob.dst, ob.cnt, dst.expand(h), ok),
        kind=set_col(ob.kind, ob.cnt, kind.expand(h), ok),
        depart_hi=set_col(ob.depart_hi, ob.cnt, dhi, ok),
        depart_lo=set_col(ob.depart_lo, ob.cnt, dlo, ok),
        ctr=set_col(ob.ctr, ob.cnt, ob.pkt_ctr.to(torch.int32), ok),
        p=set_col(ob.p, ob.cnt, p, ok),
        cnt=ob.cnt + ok.to(torch.int32),
        pkt_ctr=ob.pkt_ctr + ok.to(torch.int64),
    )
    return ob, ok


def outbox_clear(ob: Outbox) -> Outbox:
    return ob._replace(cnt=torch.zeros_like(ob.cnt))

"""Batched event buffers — the per-host priority queues as [C, H] tensors.

Port of ``shadow1_tpu/core/events.py``. All H queues live in one set of
fixed-capacity slot-major, host-minor planes; within a host, events pop in
(time, tb) order, where ``tb`` is a tie-break fixed at creation (the host's
own counter for local pushes, ``consts.packet_tb`` for delivered packets),
so the pair is unique per host and pop order is engine-independent.

Every [C, H] plane is i32, as in the reference: the absolute time rides as
an order-preserving (hi, lo) split, and pops run on the rebased ``t32`` key
(``clamp(time - epoch)``, refreshed once per window by ``rebase``) and the
split tie-break planes.

The round-path operations — ``pop_until``, ``push_local``, ``push_back`` —
have hand-written CUDA kernels (``core/popk.py``, ``csrc/popk.cu``). This
module holds their plain PyTorch versions (``*_plain``), which compute
exactly what the reference's "xla" path computes; ``core/popk.py`` sends
CPU tensors here and CUDA tensors to the kernels. Window-granularity
operations (``rebase``, ``deliver_batch``, ``evbuf_fill``) are plain tensor
code on every device, as they were XLA on the TPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shadow1_tpu_torch.consts import K_NONE, NP
from shadow1_tpu_torch.core.dense import extract_col, first_true

I64_MAX = (1 << 63) - 1
I32_MAX = (1 << 31) - 1
# Free/ineligible sentinel for the t32 plane; live far-future events clamp
# to I32_HORIZON. Both are ≥ any valid until32 (window < 2**31), so neither
# can pop. Past-due events (left by a max_rounds cap-hit window) rebase to
# negative t32, down to I32_PASTDUE.
I32_FREE = I32_MAX
I32_HORIZON = I32_MAX - 1
I32_PASTDUE = -I32_HORIZON
_LO_BIAS = 1 << 31


def tb_split(tb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """i64 (≥ 0) → (hi, lo) i32, signed-order-preserving.

    hi = tb >> 32; lo is the low word with its sign bit flipped, so signed
    i32 order equals unsigned low-word order. As an int, flipping bit 31 of
    a u32 ``u`` and reading it as i32 gives ``u - 2**31`` — one subtraction
    in int64, exact for every low word, including those ≥ 2**31."""
    hi = (tb >> 32).to(torch.int32)
    lo = ((tb & 0xFFFFFFFF) - _LO_BIAS).to(torch.int32)
    return hi, lo


def tb_join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Inverse of tb_split."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + _LO_BIAS)


def _t32_of(time: torch.Tensor, epoch) -> torch.Tensor:
    """Rebased saturating pop key."""
    return torch.clamp(time - epoch, I32_PASTDUE, I32_HORIZON).to(torch.int32)


class EventBuf(NamedTuple):
    time_hi: torch.Tensor   # i32 [C, H] absolute time, high word
    time_lo: torch.Tensor   # i32 [C, H] absolute time, low word (sign-flip)
    t32: torch.Tensor       # i32 [C, H] rebased pop key (I32_FREE = empty)
    tb_hi: torch.Tensor     # i32 [C, H] tie-break high word
    tb_lo: torch.Tensor     # i32 [C, H] tie-break low word (sign-flipped)
    kind: torch.Tensor      # i32 [C, H] (K_NONE = free slot)
    p: torch.Tensor         # i32 [NP, C, H] payload columns
    self_ctr: torch.Tensor  # i64 [H] counter for locally-pushed tb keys
    epoch: torch.Tensor     # i64 scalar — t32 = clamp(time - epoch)
    # Per-host count of events eligible before ``u32``, kept up to date by
    # push/pop so the round loop's continue test reads [H], not [C, H].
    n_elig: torch.Tensor    # i32 [H]
    u32: torch.Tensor       # i32 scalar eligibility bound of n_elig

    def abs_time(self) -> torch.Tensor:
        """i64 [C, H] absolute times (window-granularity readers only)."""
        return tb_join(self.time_hi, self.time_lo)


class Popped(NamedTuple):
    mask: torch.Tensor  # bool [H] — host had an eligible event this round
    time: torch.Tensor  # i64 [H] absolute
    kind: torch.Tensor  # i32 [H] (K_NONE where ~mask)
    p: torch.Tensor     # i32 [NP, H]
    tb: torch.Tensor    # i64 [H] original tie-break


def evbuf_init(n_hosts: int, cap: int, device) -> EventBuf:
    thi, tlo = tb_split(torch.tensor(I64_MAX, dtype=torch.int64))
    i32 = dict(dtype=torch.int32, device=device)
    return EventBuf(
        time_hi=torch.full((cap, n_hosts), int(thi), **i32),
        time_lo=torch.full((cap, n_hosts), int(tlo), **i32),
        t32=torch.full((cap, n_hosts), I32_FREE, **i32),
        tb_hi=torch.zeros((cap, n_hosts), **i32),
        tb_lo=torch.zeros((cap, n_hosts), **i32),
        kind=torch.full((cap, n_hosts), K_NONE, **i32),
        p=torch.zeros((NP, cap, n_hosts), **i32),
        self_ctr=torch.zeros(n_hosts, dtype=torch.int64, device=device),
        epoch=torch.zeros((), dtype=torch.int64, device=device),
        n_elig=torch.zeros(n_hosts, **i32),
        u32=torch.tensor(I32_HORIZON, **i32),
    )


def rebase(buf: EventBuf, epoch, until=None) -> EventBuf:
    """Advance the t32 plane's epoch (once per window) and recount
    ``n_elig`` against ``until`` (default: the saturation horizon)."""
    dev = buf.kind.device
    epoch = torch.as_tensor(epoch, dtype=torch.int64, device=dev)
    t32 = torch.where(buf.kind != K_NONE, _t32_of(buf.abs_time(), epoch), I32_FREE)
    if until is None:
        u32 = torch.tensor(I32_HORIZON, dtype=torch.int32, device=dev)
    else:
        until = torch.as_tensor(until, dtype=torch.int64, device=dev)
        u32 = torch.clamp(until - epoch, 0, I32_HORIZON).to(torch.int32)
    n_elig = (t32 < u32).sum(dim=0, dtype=torch.int32)
    return buf._replace(t32=t32, epoch=epoch, n_elig=n_elig, u32=u32)


def _push_plain(buf: EventBuf, mask, time, tb, kind, p):
    has_free, first = first_true(buf.kind == K_NONE)
    ok = mask & has_free
    w = first & ok[None, :]
    time = time.to(torch.int64)
    thi, tlo = tb_split(time)
    t32v = _t32_of(time, buf.epoch)
    hi, lo = tb_split(tb.to(torch.int64))
    kind = torch.as_tensor(kind, dtype=torch.int32, device=w.device)
    buf = buf._replace(
        time_hi=torch.where(w, thi[None, :], buf.time_hi),
        time_lo=torch.where(w, tlo[None, :], buf.time_lo),
        t32=torch.where(w, t32v[None, :], buf.t32),
        tb_hi=torch.where(w, hi[None, :], buf.tb_hi),
        tb_lo=torch.where(w, lo[None, :], buf.tb_lo),
        kind=torch.where(w, kind.expand(w.shape[1])[None, :], buf.kind),
        p=torch.where(w[None], p.to(torch.int32)[:, None, :], buf.p),
        n_elig=buf.n_elig + (ok & (t32v < buf.u32)).to(torch.int32),
    )
    return buf, ok, mask & ~has_free


def push_local_plain(buf: EventBuf, mask, time, kind, p) -> tuple[EventBuf, torch.Tensor]:
    """Push one event per host where ``mask`` into its first free slot, tb
    from the host's own counter. Returns (buf, overflow_mask): events with
    no free slot are dropped and must be counted by the caller."""
    buf, ok, over = _push_plain(buf, mask, time, buf.self_ctr, kind, p)
    return buf._replace(self_ctr=buf.self_ctr + ok.to(torch.int64)), over


def push_back_plain(buf: EventBuf, mask, time, tb, kind, p) -> tuple[EventBuf, torch.Tensor]:
    """Re-insert a popped event with its ORIGINAL tie-break key (the
    virtual-CPU requeue). Does not advance self_ctr."""
    buf, _, over = _push_plain(buf, mask, time, tb, kind, p)
    return buf, over


def until32(buf: EventBuf, until) -> torch.Tensor:
    """Rebased eligibility bound, i32 scalar tensor."""
    return torch.clamp(until - buf.epoch, 0, I32_HORIZON).to(torch.int32)


def pop_until_plain(buf: EventBuf, until, extract: str = "sum") -> tuple[EventBuf, Popped]:
    """Per-host pop of the minimum-(time, tb) event with time < until.

    The reference's 3-step lexicographic masked min over the slot axis
    (t32, then tb_hi among time ties, then tb_lo), ending in an equality
    one-hot — exact because (time, tb) is unique per host — with kind and
    payload leaving by masked sum. ``extract="gather"`` is accepted as a
    key: the reference proves it bit-identical, so one form serves both."""
    assert extract in ("sum", "gather"), f"bad pop_extract {extract!r}"
    u32 = until32(buf, until)
    elig = (buf.kind != K_NONE) & (buf.t32 < u32)
    t_masked = torch.where(elig, buf.t32, I32_FREE)
    min_t = t_masked.amin(dim=0)
    mask = min_t < u32
    tie = elig & (t_masked == min_t[None, :])
    hi_masked = torch.where(tie, buf.tb_hi, I32_MAX)
    min_hi = hi_masked.amin(dim=0)
    tie2 = tie & (hi_masked == min_hi[None, :])
    lo_masked = torch.where(tie2, buf.tb_lo, I32_MAX)
    min_lo = lo_masked.amin(dim=0)
    sel = tie2 & (lo_masked == min_lo[None, :])    # one-hot per active host
    ev = Popped(
        mask=mask,
        time=torch.where(mask, buf.epoch + min_t.to(torch.int64), 0),
        kind=extract_col(sel, buf.kind),
        p=extract_col(sel, buf.p),
        tb=torch.where(mask, tb_join(min_hi, min_lo), 0),
    )
    buf = buf._replace(
        kind=torch.where(sel, K_NONE, buf.kind),
        t32=torch.where(sel, I32_FREE, buf.t32),
        n_elig=buf.n_elig - mask.to(torch.int32),
    )
    return buf, ev


def any_eligible(buf: EventBuf) -> bool:
    """True if any host still has an eligible event (reads the [H]
    counters kept against the bound pinned by the last ``rebase``). One
    device-to-host sync."""
    return bool((buf.n_elig > 0).any())


def evbuf_fill(buf: EventBuf) -> torch.Tensor:
    """Occupancy gauge: pending events on the busiest host, i64 scalar."""
    return (buf.kind != K_NONE).sum(dim=0, dtype=torch.int32).amax().to(torch.int64)


def deliver_batch(buf: EventBuf, dst, time, tb, kind, p, mask) -> tuple[EventBuf, torch.Tensor]:
    """Merge N externally-created events into their hosts' buffers.

    Packets sort by destination (masked ones to the end); each host's r-th
    free slot, in ascending slot order, takes the r-th packet of its
    segment. The sort key packs (dst, flat index) into one int64, so keys
    are distinct and ``torch.sort`` needs no stability; segment bounds come
    from one searchsorted (side "left"). Writes the absolute time planes
    and leaves t32 stale — the next ``rebase`` repairs it. ``p`` is
    [NP, N]. Returns (buf, n_overflow)."""
    cap, n_hosts = buf.kind.shape
    dev = buf.kind.device
    n = dst.shape[0]
    nb = max((n - 1).bit_length(), 1)
    key = (torch.where(mask, dst, n_hosts).to(torch.int64) << nb) | torch.arange(
        n, dtype=torch.int64, device=dev)
    key_s = torch.sort(key).values
    dst_s = (key_s >> nb).to(torch.int32)
    hs = torch.arange(n_hosts + 1, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(dst_s, hs, right=False)
    n_in = seg[1:] - seg[:-1]                                 # [H]
    free = buf.kind == K_NONE                                 # [C, H]
    free_i = free.to(torch.int64)
    free_rank = torch.cumsum(free_i, dim=0) - free_i
    take = free & (free_rank < n_in[None, :])                 # slot receives one
    src = torch.clamp(seg[:-1][None, :] + free_rank, max=n - 1)
    oidx = (key_s & ((1 << nb) - 1))[src]                     # [C, H] flat idx
    thi, tlo = tb_split(time.to(torch.int64))
    bhi, blo = tb_split(tb.to(torch.int64))
    stacked = torch.cat([torch.stack([thi, tlo, bhi, blo, kind.to(torch.int32)]),
                         p.to(torch.int32)])                  # [5+NP, N]
    g = stacked[:, oidx]                                      # [5+NP, C, H]
    buf = buf._replace(
        time_hi=torch.where(take, g[0], buf.time_hi),
        time_lo=torch.where(take, g[1], buf.time_lo),
        tb_hi=torch.where(take, g[2], buf.tb_hi),
        tb_lo=torch.where(take, g[3], buf.tb_lo),
        kind=torch.where(take, g[4], buf.kind),
        p=torch.where(take[None], g[5:], buf.p),
    )
    free_cnt = free_i.sum(dim=0)
    n_over = mask.sum() - torch.minimum(n_in, free_cnt).sum()
    return buf, n_over

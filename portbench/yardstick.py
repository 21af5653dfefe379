"""The yardstick of the kernels: the card's memory rate and each hand
kernel's byte bound for the arguments of one call.

A byte bound counts each word the public function must move once: its
inputs where the data says they are needed, its outputs in full, for the
data it is given. The bound's time is these bytes at the card's memory
rate. The functions read the program's ``EventBuf`` / ``Outbox`` planes by
field name and compute with plain tensor operations of their own.
"""

from __future__ import annotations

import torch

# H100 SXM device-memory rate (NVIDIA data sheet), the byte bound's rate.
HBM_BYTES_PER_S = 3.35e12

NP = 10                       # payload words per event
I32_FREE = 2**31 - 1          # t32 of an empty slot
I32_HORIZON = I32_FREE - 1
I32_PASTDUE = -I32_HORIZON


def until32(buf, until) -> torch.Tensor:
    """The rebased eligibility bound: a scalar clamped into [0, horizon],
    or one bound per column clamped into [past-due, horizon]."""
    if isinstance(until, torch.Tensor) and until.dim() == 1:
        return torch.clamp(until - buf.epoch, I32_PASTDUE,
                           I32_HORIZON).to(torch.int32)
    return torch.clamp(until - buf.epoch, 0, I32_HORIZON).to(torch.int32)


def pop_bytes(buf, until) -> int:
    """pop_until: read the t32 plane; kind at each slot the argmin must
    examine (t32 below the bound and at most the host's least eligible
    t32); both tie-break words at the eligible slots that tie on that
    least t32; the NP payload words at the popped slot; the n_elig row,
    the bound and the epoch. Write t32 and kind at that slot, the popped
    rows (mask 1 B, time 8, tb 8, kind 4, payload 4·NP) and n_elig."""
    cap, h = buf.kind.shape
    lt = buf.t32 < until32(buf, until)
    elig = lt & (buf.kind != 0)
    least = torch.where(elig, buf.t32, I32_FREE).amin(0)
    n_exam = int((lt & (buf.t32 <= least)).sum())
    n_tie = int((elig & (buf.t32 == least)).sum())
    n_pop = int(elig.any(dim=0).sum())
    return (4 * cap * h + 4 * n_exam + 8 * n_tie + (4 * NP + 8) * n_pop
            + (1 + 8 + 8 + 4 + 4 * NP + 4 + 4) * h + 16)


def push_bytes(buf, mask, local: bool) -> int:
    """push_local / push_back: read the mask row, kind up to each pushing
    host's first free slot, and where a push lands its time, tie-break
    (push_back), kind and NP payload words; write the 6 + NP words into
    the slot; read n_elig, epoch and the bound and write n_elig and the
    overflow rows; push_local also reads and writes self_ctr."""
    cap, h = buf.kind.shape
    free = buf.kind == 0
    first = torch.where(free, torch.arange(cap, device=free.device)[:, None],
                        cap).amin(0)
    n_ok = int((mask & (first < cap)).sum())
    scan = int((first[mask] + 1).clamp(max=cap).sum())
    per_ok = 8 + 4 + 4 * NP + 4 * (6 + NP) + (0 if local else 8)
    return (h + 4 * scan + per_ok * n_ok + (4 + 4 + 1) * h + 12
            + (16 * h if local else 0))


def obox_bytes(ob, mask, dst, kind, depart) -> int:
    """outbox_append: read the mask (1 B), cnt (4) and pkt_ctr (8) rows and
    write the ok, cnt and pkt_ctr rows (1 + 4 + 8); for each host whose
    packet lands read its dst (4), kind (4), depart (8) and NP payload
    words, and write the 5 + NP words at its slot. A 0-d dst, kind or
    depart is read once."""
    cap, h = ob.dst.shape
    n = int((mask & (ob.cnt >= 0) & (ob.cnt < cap)).sum())
    vals = sum(size * (n if x.dim() else min(n, 1))
               for x, size in ((dst, 4), (kind, 4), (depart, 8)))
    return 26 * h + vals + 4 * NP * n + 4 * (5 + NP) * n

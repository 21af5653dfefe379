"""Dense per-host update/select primitives (port of ``core/dense.py``).

Layout contract, as in the JAX package: the HOST axis is the last (minor)
axis of every per-host tensor and the slot axis second to last —
``[C, H]``, ``[NP, C, H]``. On the card this puts neighbouring hosts at
neighbouring addresses, so a thread per host looping over slots reads
coalesced memory (the kernels in ``csrc/popk.cu``).

These are the helpers the plain versions of the kernels use; each is the
one-hot ``where`` / masked-sum form of the reference, so the plain versions
compute exactly what the reference's "xla" path computes.
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch.consts import NP


def onehot_col(col: torch.Tensor, cap: int, mask=None) -> torch.Tensor:
    """bool [C, H]: True at (col[h], h) where mask[h] (and col in range)."""
    sel = torch.arange(cap, dtype=col.dtype, device=col.device)[:, None] == col[None, :]
    if mask is not None:
        sel = sel & mask[None, :]
    return sel


def set_col(arr: torch.Tensor, col, val, mask=None) -> torch.Tensor:
    """Dense ``arr[..., col[h], h] = val[..., h] where mask[h]`` for
    [*L, C, H] arrays; ``val`` is [H] or [*L, H]."""
    sel = onehot_col(col, arr.shape[-2], mask)
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    return torch.where(sel, val.unsqueeze(-2), arr)


def extract_col(sel: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Value at the one-hot True of ``sel`` per host: [*L, C, H] → [*L, H].
    Hosts with no True read 0. Summed in the array's own dtype."""
    return torch.where(sel, arr, 0).sum(dim=-2, dtype=arr.dtype)


def first_true(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-host first True of a bool [C, H]: (any[H], onehot [C, H])."""
    cap = m.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=m.device)[:, None]
    first = torch.where(m, iota, cap).amin(dim=0)
    any_ = first < cap
    return any_, (iota == first[None, :]) & any_[None, :]


def payload(n_hosts: int, *rows, device=None) -> torch.Tensor:
    """An [NP, H] i32 payload from per-plane [H] rows (None = zeros)."""
    if len(rows) > NP:
        raise ValueError(f"payload(): {len(rows)} rows > NP={NP} planes")
    out = torch.zeros((NP, n_hosts), dtype=torch.int32, device=device)
    for i, r in enumerate(rows):
        if r is not None:
            out[i] = torch.as_tensor(r, dtype=torch.int32, device=device)
    return out

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

import functools

import torch

from shadow1_tpu_torch.consts import NP


@functools.lru_cache(maxsize=None)
def iota_col(cap: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``arange(cap)`` as a [C, 1] column, made once per (cap, dtype,
    device); callers must not write into it."""
    return torch.arange(cap, dtype=dtype, device=device)[:, None]


def onehot_col(col: torch.Tensor, cap: int, mask=None) -> torch.Tensor:
    """bool [C, H]: True at (col[h], h) where mask[h] (and col in range)."""
    sel = iota_col(cap, col.dtype, col.device) == col[None, :]
    if mask is not None:
        sel = sel & mask[None, :]
    return sel


def set_col(arr: torch.Tensor, col, val, mask=None) -> torch.Tensor:
    """Dense ``arr[..., col[h], h] = val[..., h] where mask[h]`` for
    [*L, C, H] arrays; ``val`` is a scalar, [H] or [*L, H]."""
    return set_sel(arr, onehot_col(col, arr.shape[-2], mask), val)


def set_sel(arr: torch.Tensor, sel: torch.Tensor, val) -> torch.Tensor:
    """``set_col`` with its bool [C, H] one-hot already built."""
    if not isinstance(val, torch.Tensor):
        return torch.where(sel, val, arr)   # a Python scalar: no copy
    val = val.to(arr.dtype)
    return torch.where(sel, val.unsqueeze(-2) if val.dim() else val, arr)


def add_col(arr: torch.Tensor, col, val, mask=None) -> torch.Tensor:
    """Dense ``arr[..., col[h], h] += val[..., h] where mask[h]``."""
    sel = onehot_col(col, arr.shape[-2], mask)
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    return arr + torch.where(sel, val.unsqueeze(-2) if val.dim() else val, 0)


def col_index(col: torch.Tensor, cap: int) -> torch.Tensor:
    """``col`` clipped into [0, cap) as the i64 index ``get_col`` gathers
    with; build it once to read several planes at the same column."""
    return torch.clamp(col, 0, cap - 1).to(torch.int64)


def get_col(arr: torch.Tensor, col: torch.Tensor, index=None) -> torch.Tensor:
    """Gather ``arr[..., col[h], h]`` → [*L, H] (col clipped into range;
    ``index`` is ``col_index(col, C)`` when the caller has it)."""
    c = col_index(col, arr.shape[-2]) if index is None else index
    idx = c.view((1,) * (arr.dim() - 1) + c.shape)
    idx = idx.expand(arr.shape[:-2] + (1,) + c.shape)
    return torch.gather(arr, -2, idx).squeeze(-2)


def extract_col(sel: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Value at the one-hot True of ``sel`` per host: [*L, C, H] → [*L, H].
    Hosts with no True read 0. Summed in the array's own dtype."""
    return torch.where(sel, arr, 0).sum(dim=-2, dtype=arr.dtype)


def first_true(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-host first True of a bool [C, H]: (any[H], onehot [C, H])."""
    cap = m.shape[0]
    iota = iota_col(cap, torch.int32, m.device)
    first = torch.where(m, iota, cap).amin(dim=0)
    any_ = first < cap
    return any_, (iota == first[None, :]) & any_[None, :]


def last_true(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-host HIGHEST True of a bool [C, H]: (any[H], index[H] i32);
    the index is 0 where no True."""
    cap = m.shape[0]
    last = torch.where(m, iota_col(cap, torch.int32, m.device), -1).amax(dim=0)
    return m.any(dim=0), torch.clamp(last, min=0)


def first_true_idx(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-host first-True INDEX of a bool [C, H]: (any[H], index[H] i32);
    the index is 0 where no True."""
    cap = m.shape[0]
    first = torch.where(m, iota_col(cap, torch.int32, m.device), cap).amin(dim=0)
    return m.any(dim=0), torch.where(first < cap, first, 0)


def payload(n_hosts: int, *rows, device=None) -> torch.Tensor:
    """An [NP, H] i32 payload from per-plane rows: [H] tensors, Python
    ints (every host the same value) or None (zeros)."""
    if len(rows) > NP:
        raise ValueError(f"payload(): {len(rows)} rows > NP={NP} planes")
    zeros = None
    out = []
    for i in range(NP):
        r = rows[i] if i < len(rows) else None
        if r is None:
            if zeros is None:
                zeros = torch.zeros(n_hosts, dtype=torch.int32, device=device)
            r = zeros
        elif isinstance(r, torch.Tensor):
            r = r.to(torch.int32).expand(n_hosts)
        else:
            r = torch.full((n_hosts,), r, dtype=torch.int32, device=device)
        out.append(r)
    return torch.stack(out)

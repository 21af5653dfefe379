"""Bit-exact capacity migration of the engine's planes (port of
``tune/resize.py``).

Runs at chunk boundaries or checkpoint load — never inside a window — on
the state's own device, and re-shapes the ``[C, H]`` event-buffer planes /
``[P, H]`` outbox planes to a new capacity. Every operation addresses the
slot axis as ``dim=-2``, so a plane with a leading axis (the payload's
``[NP, C, H]``) migrates like the others:

* **grow**: append free-slot rows (exactly the ``evbuf_init`` /
  ``outbox_init`` fill values), occupied slots untouched;
* **shrink**: stable-compact each host column's OCCUPIED slots to the
  front, then truncate. Raises if any host holds more events than the new
  cap — the controller only shrinks to ladder steps above the measured
  high-water, so a refusal means the caller's policy is broken, not the
  data.

Exactness: pop order is decided by the (time, tb) keys alone and free-slot
content is never read (every reader masks on ``kind != K_NONE`` /
``slot < cnt``), so any permutation of a column's occupied slots plus any
free-slot padding is semantically the identity; runs stay bit-exact
across a migration while the overflow counters stay 0.

The result's migrated planes are fresh tensors; every other leaf is the
input's own tensor (on CUDA the next chunk's kernels update planes in
place, so a caller that keeps the input clones it first).
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch.consts import K_NONE
from shadow1_tpu_torch.core.events import I32_FREE, I64_MAX, tb_split

_EV_PLANES = ("time_hi", "time_lo", "t32", "tb_hi", "tb_lo", "kind", "p")
_OB_PLANES = ("dst", "kind", "depart_hi", "depart_lo", "ctr", "p")


def _pad_rows(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """Append ``n`` slot rows (dim -2) filled with ``fill``."""
    pad = torch.full(x.shape[:-2] + (n, x.shape[-1]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-2)


def resize_evbuf(buf, new_cap: int):
    """EventBuf at cap C → the same queue contents at ``new_cap``. The [H]
    and scalar leaves (self_ctr, epoch, n_elig, u32) are
    capacity-independent and carried as they are."""
    cap = buf.kind.shape[-2]
    new_cap = int(new_cap)
    if new_cap == cap:
        return buf
    planes = {f: getattr(buf, f) for f in _EV_PLANES}
    if new_cap < cap:
        occupied = planes["kind"] != K_NONE
        n_occ = int(occupied.sum(dim=-2).max())
        if n_occ > new_cap:
            raise ValueError(
                f"cannot shrink ev_cap {cap} -> {new_cap}: a host holds "
                f"{n_occ} events")
        # Stable partition: occupied slots first, their slot order kept
        # (a stable sort of the free flag keeps ties in slot order).
        order = torch.sort((~occupied).to(torch.int8), dim=-2,
                           stable=True).indices
        for f, x in planes.items():
            o = order.expand(x.shape) if x.dim() > order.dim() else order
            planes[f] = torch.gather(x, -2, o)[..., :new_cap, :].contiguous()
    else:
        thi, tlo = tb_split(torch.tensor(I64_MAX, dtype=torch.int64))
        n = new_cap - cap
        planes["time_hi"] = _pad_rows(planes["time_hi"], n, int(thi))
        planes["time_lo"] = _pad_rows(planes["time_lo"], n, int(tlo))
        planes["t32"] = _pad_rows(planes["t32"], n, I32_FREE)
        for f in ("tb_hi", "tb_lo", "p"):
            planes[f] = _pad_rows(planes[f], n, 0)
        planes["kind"] = _pad_rows(planes["kind"], n, K_NONE)
    return buf._replace(**planes)


def resize_outbox(ob, new_cap: int):
    """Outbox at cap P → ``new_cap``. Entries are contiguous in [0, cnt)
    per host and cleared at window end (chunk boundaries see cnt == 0), so
    grow pads rows and shrink truncates."""
    cap = ob.dst.shape[-2]
    new_cap = int(new_cap)
    if new_cap == cap:
        return ob
    if new_cap < cap:
        most = int(ob.cnt.max())
        if most > new_cap:
            raise ValueError(
                f"cannot shrink outbox_cap {cap} -> {new_cap}: a host has "
                f"{most} pending sends")
    planes = {}
    for f in _OB_PLANES:
        x = getattr(ob, f)
        planes[f] = (x[..., :new_cap, :].contiguous() if new_cap < cap
                     else _pad_rows(x, new_cap - cap, 0))
    return ob._replace(**planes)


def resize_state(st, ev_cap: int | None = None, outbox_cap: int | None = None):
    """SimState → SimState with the event buffer / outbox migrated, on the
    state's device. Metrics, model state, cpu_busy and the telemetry planes
    are capacity-independent and pass through as they are."""
    repl = {}
    if ev_cap is not None and int(ev_cap) != st.evbuf.kind.shape[-2]:
        repl["evbuf"] = resize_evbuf(st.evbuf, ev_cap)
    if outbox_cap is not None and int(outbox_cap) != st.outbox.dst.shape[-2]:
        repl["outbox"] = resize_outbox(st.outbox, outbox_cap)
    return st._replace(**repl) if repl else st

"""The event core's round-path kernels: hand-written CUDA, plain beside.

Port of ``shadow1_tpu/core/popk.py``, whose three Pallas kernels are the
only TPU kernels of the JAX package. Each becomes a CUDA C++ kernel for
Hopper in ``csrc/popk.cu`` (built by ``core/_build.py``, bound with
``ctypes``):

=============  ======================================  =====================
kernel         replaces (shadow1_tpu/core/popk.py)     plain version
=============  ======================================  =====================
``pop``        ``_pop_kernel`` :98, ``pop_until_fused``  ``events.pop_until_plain``
``push``       ``_push_kernel`` :194, ``_push_fused``    ``events.push_local_plain`` /
                                                       ``events.push_back_plain``
``obox``       ``_obox_kernel`` :290,                  ``outbox.outbox_append_plain``
               ``outbox_append_fused``
=============  ======================================  =====================

``pop_until``, ``push_local``, ``push_back`` and ``outbox_append`` below
are what the engine and the models call. They dispatch on the device of
the buffer they are given: a CUDA tensor goes to the kernel (which raises
if it cannot launch — there is no fallback), a CPU tensor to the plain
version.

On CUDA, ``pop_until``, ``push_local``, ``push_back`` and
``outbox_append`` are one kernel launch each and no other device
operation: the kernel computes the whole function, the [H] rebuild the TPU
wrapper did around its kernel included (the rebased bound, the i64 time
and tie-break splits, ``n_elig``, ``self_ctr``; for the outbox the ``ok``
mask, ``cnt`` and ``pkt_ctr``). Their [H] results (the ``Popped`` rows,
the overflow and ``ok`` masks, ``n_elig``, ``self_ctr``, ``cnt``,
``pkt_ctr``) are fresh tensors; the [C, H] and [P, H] planes are updated
IN PLACE, the way the TPU kernels alias their inputs, so the returned
``EventBuf`` / ``Outbox`` holds the plane tensors it was given, mutated.
An argument that already has the kernel's dtype, shape and layout is
handed over as it is; any other is converted first (``_arg``).

Every kernel launch adds one to ``LAUNCHES[name]``, and nothing else does,
so a run can show that its main path went through the kernels; the push
kernel's launches are also counted by public entry in ``PUSH_ENTRIES``
(``push_local``, ``push_back``).

The port runs PHOLD and the net model with the ``filexfer``, ``tgen``,
``dgram``, ``tor`` and ``bitcoin`` apps (NIC with its queue bounds and RED
AQM, TCP, UDP sends, the per-window state digests and telemetry ring), the
fault plane and the fidelity gates, with active-host compaction
(``core/compact.py``: under it the kernels get the bucket's ``[C, cap]``
planes, fresh contiguous copies), and every ``engine.scheduler``: the
sharded engine (``shard/engine.py``) runs the kernels unchanged on each
rank's block of host columns.

A fleet (``fleet/engine.py``) folds its lanes onto the host axis, so the
kernels run unchanged at E·H host columns; its one new form is pop's bound
per host (``until`` [H], read at host stride 1), for lanes that stop at
different ``max_rounds``.

``push_back``'s kernel is the push kernel with the original tie-break; the
engine reaches it under the virtual CPU (``has_cpu``), once per round, to
put back the events it defers past the window's end.
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch.consts import NP
from shadow1_tpu_torch.core.events import (
    EventBuf,
    Popped,
    pop_until_plain,
    push_back_plain,
    push_local_plain,
)
from shadow1_tpu_torch.core.outbox import Outbox, outbox_append_plain

# Kernel launches on CUDA tensors, by kernel name; set to 0 to start a count.
LAUNCHES = {"pop": 0, "push": 0, "obox": 0}
# The push kernel's launches by public entry; they sum to LAUNCHES["push"].
PUSH_ENTRIES = {"push_local": 0, "push_back": 0}
# Callables handed each launch's arguments (``core/graph.py`` learns from
# them which tensors a handler pass reads); empty otherwise.
WATCH: list = []

_I32, _I64 = torch.int32, torch.int64


def _check(name: str, device: torch.device, specs) -> None:
    """Every tensor handed to a kernel: on ``device``, of its dtype and
    shape, contiguous. ``specs`` holds (arg, tensor, dtype, shape); one
    pass, and a message is built only for a tensor that fails."""
    for arg, t, dtype, shape in specs:
        if (t.dtype != dtype or t.shape != shape or t.device != device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} tensor of shape "
                f"{tuple(shape)} on {device}, got {t.dtype}{tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})")


def _arg(x, dtype, shape, device) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor of ``shape`` on ``device``.
    A tensor that already is one passes through untouched (no device
    operation); anything else is converted, broadcast and copied."""
    if (isinstance(x, torch.Tensor) and x.dtype == dtype and x.shape == shape
            and x.device == device and x.is_contiguous()):
        return x
    return torch.as_tensor(x, device=device).to(dtype).expand(shape).contiguous()


def _launch(name: str, fn, *args) -> None:
    """Call a kernel's C entry point (tensors pass as device pointers, None
    as NULL) and count the launch; raise if CUDA refused it."""
    for watch in WATCH:
        watch(args)
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args))
    if err != 0:
        # cudaErrorMemoryAllocation (2) carries the runtime's own text, so
        # the memory plane (mem.is_oom) classifies it as an OOM.
        text = "out of memory" if err == 2 else f"code {err}"
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: CUDA "
                           f"error: {text} (cudaError {err})")
    LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- pop ------------------------------------------------------------------

def pop_until(buf: EventBuf, until, extract: str = "sum") -> tuple[EventBuf, Popped]:
    """Per-host pop of the minimum-(time, tb) event with time < until (see
    ``events.pop_until_plain``); ``until`` is 0-d, or [H] with one bound per
    host. CUDA: one launch of the pop kernel, which reads ``until`` and
    ``epoch`` on the device; CPU: the plain version."""
    if not buf.kind.is_cuda:
        return pop_until_plain(buf, until, extract)
    if extract not in ("sum", "gather"):
        raise ValueError(f"bad pop_extract {extract!r}")
    from shadow1_tpu_torch.core._build import library

    cap, h = buf.kind.shape
    dev = buf.kind.device
    until, until_step = _row(torch.as_tensor(until), _I64, h, dev)
    plane, row = (cap, h), (h,)
    _check("pop", dev, (
        ("t32", buf.t32, _I32, plane), ("tb_hi", buf.tb_hi, _I32, plane),
        ("tb_lo", buf.tb_lo, _I32, plane), ("kind", buf.kind, _I32, plane),
        ("p", buf.p, _I32, (NP, cap, h)), ("epoch", buf.epoch, _I64, ()),
        ("n_elig", buf.n_elig, _I32, row)))
    out = Popped(
        mask=torch.empty(h, dtype=torch.bool, device=dev),
        time=torch.empty(h, dtype=_I64, device=dev),
        kind=torch.empty(h, dtype=_I32, device=dev),
        p=torch.empty((NP, h), dtype=_I32, device=dev),
        tb=torch.empty(h, dtype=_I64, device=dev))
    n_elig = torch.empty(h, dtype=_I32, device=dev)
    _launch("pop", library().popk_pop, until, buf.epoch, buf.t32, buf.tb_hi,
            buf.tb_lo, buf.kind, buf.p, buf.n_elig, out.mask, out.time,
            out.tb, out.kind, out.p, n_elig, cap, h, until_step, _stream(dev))
    return buf._replace(n_elig=n_elig), out


# -- push -----------------------------------------------------------------

def _push_cuda(buf: EventBuf, mask, time, tb, kind, p, *, advance_ctr: bool):
    """One launch of the push kernel: where ``mask``, the event goes into
    the host's first free slot, in place. Returns (buf with the new
    ``n_elig`` — and ``self_ctr`` when ``advance_ctr`` (``push_local``) —,
    overflow)."""
    from shadow1_tpu_torch.core._build import library

    cap, h = buf.kind.shape
    dev = buf.kind.device
    plane, row = (cap, h), (h,)
    mask = _arg(mask, torch.bool, row, dev)
    time = _arg(time, _I64, row, dev)
    tb = _arg(tb, _I64, row, dev)
    kind = _arg(kind, _I32, row, dev)
    p = _arg(p, _I32, (NP, h), dev)
    _check("push", dev, (
        ("time_hi", buf.time_hi, _I32, plane),
        ("time_lo", buf.time_lo, _I32, plane), ("t32", buf.t32, _I32, plane),
        ("tb_hi", buf.tb_hi, _I32, plane), ("tb_lo", buf.tb_lo, _I32, plane),
        ("kind", buf.kind, _I32, plane), ("p", buf.p, _I32, (NP, cap, h)),
        ("epoch", buf.epoch, _I64, ()), ("u32", buf.u32, _I32, ()),
        ("n_elig", buf.n_elig, _I32, row)))
    over = torch.empty(h, dtype=torch.bool, device=dev)
    n_elig = torch.empty(h, dtype=_I32, device=dev)
    ctr = torch.empty(h, dtype=_I64, device=dev) if advance_ctr else None
    _launch("push", library().popk_push, mask, time, tb, kind, p, buf.epoch,
            buf.u32, buf.n_elig, buf.time_hi, buf.time_lo, buf.t32,
            buf.tb_hi, buf.tb_lo, buf.kind, buf.p, over, n_elig, ctr, cap, h,
            int(advance_ctr), _stream(dev))
    PUSH_ENTRIES["push_local" if advance_ctr else "push_back"] += 1
    if advance_ctr:
        return buf._replace(n_elig=n_elig, self_ctr=ctr), over
    return buf._replace(n_elig=n_elig), over


def push_local(buf: EventBuf, mask, time, kind, p) -> tuple[EventBuf, torch.Tensor]:
    """Push one event per host where ``mask``, tb from the host's counter
    (see ``events.push_local_plain``). Returns (buf, overflow_mask)."""
    if not buf.kind.is_cuda:
        return push_local_plain(buf, mask, time, kind, p)
    return _push_cuda(buf, mask, time, buf.self_ctr, kind, p, advance_ctr=True)


def push_back(buf: EventBuf, mask, time, tb, kind, p) -> tuple[EventBuf, torch.Tensor]:
    """Re-insert popped events with their original tie-break (see
    ``events.push_back_plain``). Returns (buf, overflow_mask)."""
    if not buf.kind.is_cuda:
        return push_back_plain(buf, mask, time, tb, kind, p)
    return _push_cuda(buf, mask, time, tb, kind, p, advance_ctr=False)


# -- outbox append --------------------------------------------------------

def _row(x: torch.Tensor, dtype, h: int, device) -> tuple[torch.Tensor, int]:
    """``x`` for a kernel that reads host h at ``h * step``: a 0-d tensor
    as one value (step 0), any other as an [H] row (step 1); a 0-d value
    is never expanded into a copy of H values."""
    if x.dim() == 0:
        return _arg(x, dtype, (), device), 0
    return _arg(x, dtype, (h,), device), 1


def outbox_append(ob: Outbox, mask, dst, kind, depart, p) -> tuple[Outbox, torch.Tensor]:
    """Append one packet per host where ``mask`` at slot ``cnt[h]`` (see
    ``outbox.outbox_append_plain``). Returns (ob, ok_mask). CUDA: one
    launch of the obox kernel, which also computes ``ok`` and the new
    ``cnt`` and ``pkt_ctr`` rows; ``dst``, ``kind`` and ``depart`` may be
    [H] rows or 0-d."""
    if not ob.dst.is_cuda:
        return outbox_append_plain(ob, mask, dst, kind, depart, p)
    from shadow1_tpu_torch.core._build import library

    cap, h = ob.dst.shape
    dev = ob.dst.device
    plane, row = (cap, h), (h,)
    mask = _arg(mask, torch.bool, row, dev)
    dst, dst_step = _row(dst, _I32, h, dev)
    kind, kind_step = _row(kind, _I32, h, dev)
    depart, depart_step = _row(depart, _I64, h, dev)
    p = _arg(p, _I32, (NP, h), dev)
    _check("obox", dev, (
        ("cnt", ob.cnt, _I32, row), ("pkt_ctr", ob.pkt_ctr, _I64, row),
        ("dst", ob.dst, _I32, plane), ("kind", ob.kind, _I32, plane),
        ("depart_hi", ob.depart_hi, _I32, plane),
        ("depart_lo", ob.depart_lo, _I32, plane),
        ("ctr", ob.ctr, _I32, plane), ("p", ob.p, _I32, (NP, cap, h))))
    ok = torch.empty(h, dtype=torch.bool, device=dev)
    cnt = torch.empty(h, dtype=_I32, device=dev)
    pkt_ctr = torch.empty(h, dtype=_I64, device=dev)
    _launch("obox", library().popk_obox, mask, ob.cnt, ob.pkt_ctr, dst, kind,
            depart, p, ob.dst, ob.kind, ob.depart_hi, ob.depart_lo, ob.ctr,
            ob.p, ok, cnt, pkt_ctr, cap, h, dst_step, kind_step, depart_step,
            _stream(dev))
    return ob._replace(cnt=cnt, pkt_ctr=pkt_ctr), ok

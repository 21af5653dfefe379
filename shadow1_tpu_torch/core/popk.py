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
version. On CUDA the kernels update the buffer's planes IN PLACE, the way
the TPU kernels alias their inputs: the returned ``EventBuf``/``Outbox``
holds the same plane tensors it was given, mutated. Each wrapper keeps the
[H]-vector rebuild the TPU wrapper does around its kernel (i64 time and tb
from the min words and ``n_elig`` for pop; ``n_elig`` and, for local
pushes, ``self_ctr`` for push; ``cnt`` and ``pkt_ctr`` for the outbox).

Every kernel launch adds one to ``LAUNCHES[name]``, and nothing else does,
so a run can show that its main path went through the kernels.

What this slice of the port leaves out, and where it is refused — each
refusal is a ``NotImplementedError`` whose message names the ROADMAP item
that will add it (``core/engine.py check_supported``,
``config/experiment.py build_experiment``, ``cli.py``, ``convert.py``):

* ``model: net`` and every app but phold — "slice 2, NIC + TCP +
  filexfer" for filexfer, "the other apps" for dgram, tgen, tor, bitcoin;
* ``faults:``, host stop times (``has_stop``), the virtual CPU
  (``cpu_per_event``, ``has_cpu``) and edge jitter (``network.jitter``,
  ``has_jitter``); link faults and loss ramps come only from ``faults:`` —
  "fault plane and fidelity gates";
* ``compact_cap`` — "compaction";
* ``metrics_ring`` and ``state_digest`` (and a state carrying a ring) —
  "digest and ring instruments";
* ``probes`` / ``probes:`` and ``link_telem`` — "checkpoint and
  observability";
* ``auto_caps`` and ``on_overflow`` other than "drop" — "recovery planes";
* ``scheduler: sharded`` — "fleet, shard, serve".

``push_back``'s kernel is the push kernel with the original tie-break; the
engine reaches it only under ``has_cpu``, which this slice refuses, so the
PHOLD path launches it through ``push_local`` alone.
"""

from __future__ import annotations

import torch

from shadow1_tpu_torch.consts import NP
from shadow1_tpu_torch.core import events as ev
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


def _check(name: str, device: torch.device, **tensors) -> None:
    """Every tensor handed to a kernel: on ``device``, int32, contiguous,
    and of the shape the kernel indexes it by (keys ``name=(t, shape)``)."""
    for arg, (t, shape) in tensors.items():
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _launch(name: str, fn, *args) -> None:
    """Call a kernel's C entry point (tensors pass as device pointers) and
    count the launch; raise if CUDA refused it."""
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch "
                           f"(cudaError {err})")
    LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _i32(x, h: int, device) -> torch.Tensor:
    """An [H] int32 contiguous row from a scalar, bool or int tensor."""
    return torch.as_tensor(x, device=device).to(torch.int32).expand(h).contiguous()


# -- pop ------------------------------------------------------------------

def pop_kernel_launch(buf: EventBuf, u32: torch.Tensor):
    """Launch the pop kernel on ``buf`` (t32 and kind cleared in place).
    Returns the raw [H] words (min_t, min_hi, min_lo, kind) and [NP, H]
    payload of the selected slots."""
    from shadow1_tpu_torch.core._build import library

    cap, h = buf.kind.shape
    dev = buf.kind.device
    u = u32.reshape(1).to(torch.int32).contiguous()
    plane = (cap, h)
    _check("pop", dev, until32=(u, (1,)), t32=(buf.t32, plane),
           tb_hi=(buf.tb_hi, plane), tb_lo=(buf.tb_lo, plane),
           kind=(buf.kind, plane), p=(buf.p, (NP, cap, h)))
    out = torch.empty((4 + NP, h), dtype=torch.int32, device=dev)
    mt, mhi, mlo, ko, po = out[0], out[1], out[2], out[3], out[4:]
    _launch("pop", library().popk_pop, u, buf.t32, buf.tb_hi, buf.tb_lo,
            buf.kind, buf.p, mt, mhi, mlo, ko, po, cap, h, _stream(dev))
    return mt, mhi, mlo, ko, po


def pop_until(buf: EventBuf, until, extract: str = "sum") -> tuple[EventBuf, Popped]:
    """Per-host pop of the minimum-(time, tb) event with time < until (see
    ``events.pop_until_plain``). CUDA: the pop kernel; CPU: the plain
    version."""
    if not buf.kind.is_cuda:
        return pop_until_plain(buf, until, extract)
    assert extract in ("sum", "gather"), f"bad pop_extract {extract!r}"
    u32 = ev.until32(buf, until)
    mt, mhi, mlo, ko, po = pop_kernel_launch(buf, u32)
    mask = mt < u32
    popped = Popped(
        mask=mask,
        time=torch.where(mask, buf.epoch + mt.to(torch.int64), 0),
        kind=ko,
        p=po,
        tb=torch.where(mask, ev.tb_join(mhi, mlo), 0),
    )
    return buf._replace(n_elig=buf.n_elig - mask.to(torch.int32)), popped


# -- push -----------------------------------------------------------------

def push_kernel_launch(buf: EventBuf, mask, thi_v, tlo_v, t32_v, bhi_v, blo_v,
                       kind_v, p_v) -> torch.Tensor:
    """Launch the push kernel: where ``mask``, write the 6 + NP value words
    into each host's first free slot, in place. Returns the i32 [H]
    overflow flags (masked hosts with no free slot)."""
    from shadow1_tpu_torch.core._build import library

    cap, h = buf.kind.shape
    dev = buf.kind.device
    plane, row = (cap, h), (h,)
    over = torch.empty(h, dtype=torch.int32, device=dev)
    _check("push", dev, mask=(mask, row), thi_v=(thi_v, row),
           tlo_v=(tlo_v, row), t32_v=(t32_v, row), bhi_v=(bhi_v, row),
           blo_v=(blo_v, row), kind_v=(kind_v, row), p_v=(p_v, (NP, h)),
           time_hi=(buf.time_hi, plane), time_lo=(buf.time_lo, plane),
           t32=(buf.t32, plane), tb_hi=(buf.tb_hi, plane),
           tb_lo=(buf.tb_lo, plane), kind=(buf.kind, plane),
           p=(buf.p, (NP, cap, h)))
    _launch("push", library().popk_push, mask, thi_v, tlo_v, t32_v, bhi_v,
            blo_v, kind_v, p_v, buf.time_hi, buf.time_lo, buf.t32, buf.tb_hi,
            buf.tb_lo, buf.kind, buf.p, over, cap, h, _stream(dev))
    return over


def _push_cuda(buf: EventBuf, mask, time, tb, kind, p, *, advance_ctr: bool):
    h = buf.kind.shape[1]
    dev = buf.kind.device
    time = time.to(torch.int64)
    thi_v, tlo_v = ev.tb_split(time)
    bhi_v, blo_v = ev.tb_split(tb.to(torch.int64))
    t32_v = ev._t32_of(time, buf.epoch)
    over = push_kernel_launch(
        buf, _i32(mask, h, dev), thi_v, tlo_v, t32_v, bhi_v, blo_v,
        _i32(kind, h, dev), p.to(torch.int32).contiguous())
    over = (over != 0) & mask
    ok = mask & ~over
    buf = buf._replace(n_elig=buf.n_elig + (ok & (t32_v < buf.u32)).to(torch.int32))
    if advance_ctr:
        buf = buf._replace(self_ctr=buf.self_ctr + ok.to(torch.int64))
    return buf, over


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

def obox_kernel_launch(ob: Outbox, ok, dst_v, kind_v, dhi_v, dlo_v, ctr_v, p_v) -> None:
    """Launch the outbox-append kernel: where ``ok``, write the 5 + NP
    value words at slot ``cnt[h]``, in place."""
    from shadow1_tpu_torch.core._build import library

    cap, h = ob.dst.shape
    dev = ob.dst.device
    plane, row = (cap, h), (h,)
    _check("obox", dev, cnt=(ob.cnt, row), ok=(ok, row), dst_v=(dst_v, row),
           kind_v=(kind_v, row), dhi_v=(dhi_v, row), dlo_v=(dlo_v, row),
           ctr_v=(ctr_v, row), p_v=(p_v, (NP, h)), dst=(ob.dst, plane),
           kind=(ob.kind, plane), depart_hi=(ob.depart_hi, plane),
           depart_lo=(ob.depart_lo, plane), ctr=(ob.ctr, plane),
           p=(ob.p, (NP, cap, h)))
    _launch("obox", library().popk_obox, ob.cnt, ok, dst_v, kind_v, dhi_v,
            dlo_v, ctr_v, p_v, ob.dst, ob.kind, ob.depart_hi, ob.depart_lo,
            ob.ctr, ob.p, cap, h, _stream(dev))


def outbox_append(ob: Outbox, mask, dst, kind, depart, p) -> tuple[Outbox, torch.Tensor]:
    """Append one packet per host where ``mask`` at slot ``cnt[h]`` (see
    ``outbox.outbox_append_plain``). Returns (ob, ok_mask)."""
    if not ob.dst.is_cuda:
        return outbox_append_plain(ob, mask, dst, kind, depart, p)
    cap, h = ob.dst.shape
    dev = ob.dst.device
    ok = mask & (ob.cnt < cap)
    dhi_v, dlo_v = ev.tb_split(depart.to(torch.int64))
    obox_kernel_launch(ob, _i32(ok, h, dev), _i32(dst, h, dev),
                       _i32(kind, h, dev), dhi_v, dlo_v,
                       ob.pkt_ctr.to(torch.int32), p.to(torch.int32).contiguous())
    ob = ob._replace(cnt=ob.cnt + ok.to(torch.int32),
                     pkt_ctr=ob.pkt_ctr + ok.to(torch.int64))
    return ob, ok

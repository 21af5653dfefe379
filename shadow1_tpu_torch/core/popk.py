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

Two more kernels replace no TPU kernel: ``rx_ack`` and ``rx_data`` run
the two per-socket blocks of TCP's receive path (``tcp_rx_ack``,
``tcp_rx_data`` below; their plain versions are ``tcp.rx_ack_plain`` and
``tcp.rx_data_plain``, and ``tcp.rx_ack`` / ``tcp.rx_data`` dispatch). They
update the TCP planes of ``RX_PLANES`` in place, and ``rx_data`` the
Notif rows that ``rx_ack`` made.

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

import ctypes

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
LAUNCHES = {"pop": 0, "push": 0, "obox": 0, "rx_ack": 0, "rx_data": 0}
# The event core's kernels, which every model's round launches; the rx
# kernels run only where TCP receives (the net model's deliver pass).
CORE = ("pop", "push", "obox")
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


# -- TCP's receive path ----------------------------------------------------

# The TCP planes the rx kernels read and write, in the order of
# ``csrc/popk.cu``'s ``TcpPlanes``: [S, H] each, bool for ``ts_act``, and
# the [Q, S, H] message-boundary FIFO last.
RX_PLANES = (
    "st", "peer_host", "peer_sock", "peer_wnd", "snd_una", "snd_nxt",
    "snd_max", "rcv_nxt", "app_end", "fin_pend", "cwnd", "ssthresh",
    "dupacks", "recover", "ts_seq", "srtt_hi", "srtt_lo", "rttvar_hi",
    "rttvar_lo", "rto_hi", "rto_lo", "rtx_t_hi", "rtx_t_lo", "ts_time_hi",
    "ts_time_lo", "ts_act", "mq_valid", "mq_end")
_RX_BOOL = frozenset(("ts_act", "mq_valid"))


def _rx_planes(name: str, tcp: dict, device) -> tuple:
    """Check every plane of ``RX_PLANES`` and return (the host array of
    their device pointers, S, Q, H). The array must outlive the launch."""
    s, h = tcp["st"].shape
    q = tcp["mq_valid"].shape[0]
    _check(name, device, tuple(
        (k, tcp[k], torch.bool if k in _RX_BOOL else _I32,
         (q, s, h) if k.startswith("mq_") else (s, h)) for k in RX_PLANES))
    ptrs = (ctypes.c_void_p * len(RX_PLANES))(
        *(tcp[k].data_ptr() for k in RX_PLANES))
    return ptrs, s, q, h


def _fits(name: str, bits: int, **vals) -> None:
    """Raise unless each value fits a signed ``bits``-bit argument."""
    for k, v in vals.items():
        if not -(1 << (bits - 1)) <= v < 1 << (bits - 1):
            raise ValueError(f"{name}: {k} = {v} does not fit the kernel's "
                             f"{bits}-bit argument")


def tcp_rx_ack(tcp: dict, params, mask, to_listener, p, now):
    """The kernel of ``tcp.rx_ack`` (see ``tcp.rx_ack_plain``): one launch
    over the [H] rows ``mask``, ``to_listener`` (the hosts whose segment is
    a SYN to a listener), the segment's payload ``p`` [NP, H] and ``now``.
    The planes of ``RX_PLANES`` are updated IN PLACE. Returns (the six
    Notif rows, fresh: sock, flags, meta, meta2, dlen, space; the five
    masks, fresh: v, est_ss, closed_by_ack, frx, flush). CUDA only."""
    from shadow1_tpu_torch.core._build import library

    dev = tcp["st"].device
    planes, s, q, h = _rx_planes("rx_ack", tcp, dev)
    pr = params
    _fits("rx_ack", 32, mss=pr.mss, mss_squared=pr.mss * pr.mss,
          sndbuf=pr.sndbuf, dupack_thresh=pr.dupack_thresh)
    _fits("rx_ack", 64, rto_min=pr.rto_min, rto_max=pr.rto_max)
    row = (h,)
    mask = _arg(mask, torch.bool, row, dev)
    to_listener = _arg(to_listener, torch.bool, row, dev)
    p = _arg(p, _I32, (NP, h), dev)
    now = _arg(now, _I64, row, dev)
    nf = torch.empty((6, h), dtype=_I32, device=dev)
    out = torch.empty((5, h), dtype=torch.bool, device=dev)
    _launch("rx_ack", library().popk_rx_ack, ctypes.addressof(planes), mask,
            to_listener, p, now, *nf, out, s, q, h, pr.mss, pr.sndbuf,
            pr.dupack_thresh, pr.rto_min, pr.rto_max, _stream(dev))
    return tuple(nf), tuple(out)


def tcp_rx_data(tcp: dict, p, nf, v, est_ss, closed_by_ack):
    """The kernel of ``tcp.rx_data`` (see ``tcp.rx_data_plain``): one launch
    over the segment's payload ``p`` and ``tcp_rx_ack``'s masks ``v``,
    ``est_ss`` and ``closed_by_ack``. The planes of ``RX_PLANES`` and the
    Notif rows ``nf`` (``tcp_rx_ack``'s) are updated IN PLACE. Returns the
    fresh masks (need_ack, out_of_order). CUDA only."""
    from shadow1_tpu_torch.core._build import library

    dev = tcp["st"].device
    planes, s, _, h = _rx_planes("rx_data", tcp, dev)
    row = (h,)
    p = _arg(p, _I32, (NP, h), dev)
    _check("rx_data", dev, (
        ("v", v, torch.bool, row), ("est_ss", est_ss, torch.bool, row),
        ("closed_by_ack", closed_by_ack, torch.bool, row),
        ("nf.sock", nf.sock, _I32, row), ("nf.flags", nf.flags, _I32, row),
        ("nf.meta", nf.meta, _I32, row), ("nf.dlen", nf.dlen, _I32, row)))
    out = torch.empty((2, h), dtype=torch.bool, device=dev)
    _launch("rx_data", library().popk_rx_data, ctypes.addressof(planes), p, v,
            est_ss, closed_by_ack, nf.sock, nf.flags, nf.meta, nf.dlen, out,
            s, h, _stream(dev))
    return out[0], out[1]

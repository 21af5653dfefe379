"""The traced passes of a ``--trace 1`` run, each from a clone of the start
state, after the timed window:

1. one pass under ``torch.profiler`` with CUDA activity alone, timed by the
   host clock from a synchronise to a synchronise: the device's busy time
   (the union of its kernel, copy and set intervals), the device time of
   every operation and of the three hand kernels. The capture still costs
   host time at every launch (tor10k's pass ran 1.4-1.7 times as long as
   an untraced one), so the idle share is taken against the untraced
   passes' wall (``metrics/device_idle_pct.py``); this pass's own wall is
   the traced window's length that the result's ``device`` reports;
2. one pass under ``torch.profiler`` with CPU and CUDA activity, inside a
   ``portbench:pass`` scope that ends in a device synchronise: the host
   time of the window phases' ``phase:*`` scopes, and the device's idle
   gaps named by the phase the host was in. Recording every CPU operation
   slows the host, so this pass's times are the traced host's;
3. one pass under an operation-counting dispatch mode (the census's
   arithmetic: every aten operation but views and the scalar read, plus
   one per hand-kernel launch, which the dispatcher never sees; and the
   synchronising reads: ``bool``, ``item``, ``tolist``, ``int``,
   ``float`` and ``index`` of a tensor, and device-to-host copies outside
   them);
4. one pass with the pop kernel's arguments kept at each call, for its
   byte bound (``yardstick.pop_bytes``).

The counting and the byte bounds add host work and reads of their own, so
they run on passes of their own, never on a profiled one. The passes are
deterministic, so each sees the same calls. Profiles stay in memory; only
their reduction leaves this module.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

from portbench import yardstick
from portbench.harness import clone_tree, synchronize

KERNELS = ("pop", "push", "obox")
READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__")
PASS_SCOPE = "portbench:pass"
PHASE_PREFIX = "phase:"


def _fresh(cell):
    cell.result = None
    held = [clone_tree(cell.start_state)]
    synchronize(cell.device)
    return held


def merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def is_device_op(e) -> bool:
    """A kernel, copy or set on the device, not an annotation that the
    profiler mirrors onto the device's timeline (the window phases' and
    this module's scopes). Profiler records of older releases lack
    ``activity_type``, so the scope names decide too."""
    if not str(e.device_type()).endswith("CUDA"):
        return False
    kind = getattr(e, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return False
    user = getattr(e, "is_user_annotation", None)
    if user is not None and user():
        return False
    name = e.name()
    return not (name.startswith(PHASE_PREFIX) or name == PASS_SCOPE)


def reduce_device(events, wall_s: float) -> dict:
    """Busy time, device time by operation and by hand kernel, from the
    raw records of the device pass; ``wall_s`` its host-clock wall."""
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if is_device_op(e)]
    busy_ns = sum(e - s for s, e in merge([(s, e) for s, e, _ in dev]))
    by_op = defaultdict(lambda: [0, 0])
    for s, e, n in dev:
        by_op[n][0] += e - s
        by_op[n][1] += 1
    kern = {k: [0, 0] for k in KERNELS}
    for n, (t, c) in by_op.items():
        for k in KERNELS:
            if f"{k}_kernel" in n:
                kern[k][0] += t
                kern[k][1] += c
    ops = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": wall_s,
        "busy_s": busy_ns / 1e9,
        "device_sum_s": sum(t for t, _ in by_op.values()) / 1e9,
        "kernel_s": {k: v[0] / 1e9 for k, v in kern.items()},
        "kernel_records": {k: v[1] for k, v in kern.items()},
        "device_ops": [[n[:160], t / 1e9] for n, (t, _) in ops],
    }


def reduce_host(events) -> dict:
    """Phase host times and the device's idle gaps by the phase the host
    was in, from the raw records of the host pass."""
    scope = None
    phases, dev = [], []
    for e in events:
        name = e.name()
        if is_device_op(e):
            dev.append((e.start_ns(), e.end_ns()))
        elif name == PASS_SCOPE and not str(e.device_type()).endswith("CUDA"):
            scope = (e.start_ns(), e.end_ns())
        elif (name.startswith(PHASE_PREFIX)
              and not str(e.device_type()).endswith("CUDA")):
            phases.append((e.start_ns(), e.end_ns(), name))
    if scope is None:
        raise RuntimeError("the profile holds no pass scope")
    s0, s1 = scope
    busy = merge([(max(s, s0), min(e, s1)) for s, e in dev
                  if e > s0 and s < s1])
    phases.sort()
    starts = [p[0] for p in phases]

    def phase_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and phases[i][1] > t:
            return phases[i][2]
        return "(between phases)"

    gaps = defaultdict(lambda: [0, 0, 0])
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            g = gaps[phase_at(a)]
            g[0] += b - a
            g[1] += 1
            g[2] = max(g[2], b - a)
    phase_ns = defaultdict(int)
    for s, e, n in phases:
        phase_ns[n] += e - s
    top = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "scope_s": (s1 - s0) / 1e9,
        "phase_s": {n: v / 1e9 for n, v in phase_ns.items()},
        "idle_gaps": [[f"{n}: {c} gaps under host tracing, longest "
                       f"{m / 1e9} s", t / 1e9] for n, (t, c, m) in top],
    }


def device_pass(cell) -> dict:
    from torch.profiler import ProfilerActivity, profile

    held = _fresh(cell)
    acts = ([ProfilerActivity.CUDA] if cell.device.type == "cuda"
            else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        synchronize(cell.device)
        t0 = time.perf_counter()
        st = cell.eng.run(held.pop(), cell.span)
        synchronize(cell.device)
        wall = time.perf_counter() - t0
    del st
    return reduce_device(prof.profiler.kineto_results.events(), wall)


def host_pass(cell) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    held = _fresh(cell)
    acts = [ProfilerActivity.CPU]
    if cell.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(PASS_SCOPE):
            st = cell.eng.run(held.pop(), cell.span)
            synchronize(cell.device)
    del st
    return reduce_host(prof.profiler.kineto_results.events())


def count_pass(cell) -> dict:
    """Operations and synchronising reads of one pass."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from shadow1_tpu_torch.core import popk

    aten = torch.ops.aten
    scalar = aten._local_scalar_dense.default
    copies = (aten._to_copy.default, aten.copy_.default)
    c = {"ops": 0, "reads": 0, "launches": {}}
    depth = [0]

    def d2h(func, args, out) -> bool:
        if func not in copies:
            return False
        src = args[1] if func is aten.copy_.default else args[0]
        dst = args[0] if func is aten.copy_.default else out
        return (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.device.type != "cpu" and dst.device.type == "cpu")

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (getattr(func, "is_view", False) or func is scalar):
                c["ops"] += 1
            if not depth[0] and d2h(func, args, out):
                c["reads"] += 1
            return out

    real = {n: getattr(torch.Tensor, n) for n in READS}
    own = {n: n in vars(torch.Tensor) for n in READS}

    def counted(method):
        def read(self, *a, **k):
            if not depth[0]:
                c["reads"] += 1
            depth[0] += 1
            try:
                return method(self, *a, **k)
            finally:
                depth[0] -= 1
        return read

    held = _fresh(cell)
    before = dict(popk.LAUNCHES)
    for n, m in real.items():
        setattr(torch.Tensor, n, counted(m))
    try:
        with Mode():
            st = cell.eng.run(held.pop(), cell.span)
    finally:
        for n, m in real.items():
            if own[n]:
                setattr(torch.Tensor, n, m)
            else:
                delattr(torch.Tensor, n)
    synchronize(cell.device)
    del st
    for k in KERNELS:
        c["launches"][k] = popk.LAUNCHES[k] - before[k]
        c["ops"] += c["launches"][k]
    return c


def pop_bytes_pass(cell) -> list[int]:
    """The pop kernel's byte bound at each call of one pass."""
    from shadow1_tpu_torch.core import engine

    real = engine.pop_until
    got = []

    def kept(buf, until, *a, **k):
        got.append(yardstick.pop_bytes(buf, until))
        return real(buf, until, *a, **k)

    held = _fresh(cell)
    engine.pop_until = kept
    try:
        st = cell.eng.run(held.pop(), cell.span)
    finally:
        engine.pop_until = real
    synchronize(cell.device)
    del st
    return got


def traced_passes(cell) -> dict:
    t0 = time.perf_counter()
    dev = device_pass(cell)
    t1 = time.perf_counter()
    host = host_pass(cell)
    t2 = time.perf_counter()
    census = count_pass(cell)
    t3 = time.perf_counter()
    pops = pop_bytes_pass(cell)
    t4 = time.perf_counter()
    print(f"traced passes: device {t1 - t0:.3f} s (pass {dev['window_s']:.6f}"
          f" s, busy {dev['busy_s']:.6f} s), host {t2 - t1:.3f} s (scope "
          f"{host['scope_s']:.6f} s), counted {t3 - t2:.3f} s, pop arguments "
          f"{t4 - t3:.3f} s; census {census}; pop calls {len(pops)}, kernel "
          f"records {dev['kernel_records']}; idle share of the traced pass "
          f"{100.0 * (1.0 - dev['busy_s'] / dev['window_s']):.6f} %",
          file=sys.stderr, flush=True)
    return {"profile": {**dev, "phase_s": host["phase_s"]},
            "census": census, "pop_bytes": pops,
            "busy_s": dev["busy_s"], "window_s": dev["window_s"],
            "breakdown": {"device_ops": dev["device_ops"],
                          "idle_gaps": host["idle_gaps"]},
            "hbm_bytes_per_s": yardstick.HBM_BYTES_PER_S}

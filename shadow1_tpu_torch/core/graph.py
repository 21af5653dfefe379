"""A handler pass replayed as a CUDA graph.

A model marks a handler ``capturable`` where it builds it: the pass reads
nothing back to the host, makes no host tensor, and its shapes follow its
inputs'. Its whole chain of device operations, hand-kernel launches
included, is then captured once as a CUDA graph and replayed each round
(``run_pass``): one ``replay`` where the eager pass launches every operation
from the host. ``core/engine.run_round`` runs a marked pass here and any
other eagerly; so does ``run_pass`` for a pass whose tensors are on a
device without graphs (``GRAPHS``: the CPU has none).

A pass takes the round's state and popped events, a tree whose tensor
leaves fall in three groups. Which leaf is in which is learned once per
handler closure and input layout, from one eager pass that watches the
torch calls and kernel launches (``_learn``; it also builds what the pass
builds on first use, such as ``rng``'s Q32 table, before any capture).
The plan is kept on the closure itself (``graph_plans``), so a closure
built anew, as compaction builds one each window, learns its own:

* leaves the pass does not read: outside the graph; an output that passes
  one through is the round's own leaf;
* leaves it reads and passes through: the ``[C, H]`` and ``[P, H]`` planes,
  which the kernels update in place, and the window's epoch. The graph
  reads them at their address, so a new address (``rebase`` and the
  window's delivery make new planes every window) means a new capture;
* leaves it reads and replaces: the popped rows, ``n_elig``, the counters.
  The graph reads a static copy of each, refreshed before a replay unless
  it already holds the value: the graph ends by copying each output made
  at the place of such a leaf into that leaf's static copy, and hands the
  copy on, so the next round's pass finds it there.

A capture does not run the pass, so the round that captures also replays.
A replay rewrites the static copies in place, so a state holding them is
good until the next replay; an output the graph makes anywhere else is
handed on as a copy. The round loop ends with ``release``, which drops
every graph, and nothing rewrites the copies after it. Each handler kind
keeps one graph, dropped before the next is captured. Every capture on a
card goes into one memory pool per device that outlives the graphs, so a
capture reuses what the one before it freed.

``popk.LAUNCHES`` and ``PUSH_ENTRIES`` count what the device runs: a
capture takes back what its kernel calls counted, and each replay adds
them again.
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves

from shadow1_tpu_torch.core import popk
from shadow1_tpu_torch.telemetry.profiler import (
    RS_GRAPH_CAPTURE,
    RS_GRAPH_REPLAY,
    round_span,
)


def capturable(fn):
    """Mark the handler pass ``fn`` as one that may be replayed as a graph
    (see the module's doc); returns ``fn``."""
    fn.capturable = True
    # The plans learned for this closure, by input layout (``run_pass``).
    fn.graph_plans = {}
    return fn


class _CudaGraph:
    """A CUDA graph of the device's work, captured on a side stream in
    ``thread_local`` mode (safe under ``torch.profiler``), in the device's
    shared pool."""

    _pools: dict = {}   # device -> (pool handle, side stream, anchor)

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, body):
        if self.device not in self._pools:
            # The pool stays open only while some graph captured into it
            # lives: a graph that is never replayed keeps it open.
            pool = torch.cuda.graph_pool_handle()
            side = torch.cuda.Stream(self.device)
            anchor = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                anchor.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
                torch.zeros(1, device=self.device)
                anchor.capture_end()
            self._pools[self.device] = (pool, side, anchor)
        pool, side, _ = self._pools[self.device]
        # A collection inside the capture could free device memory with a
        # call the capture refuses.
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    return body()
                finally:
                    self.graph.capture_end()
        finally:
            if collect:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


# The graph of a pass by its tensors' device type; a device type not here
# runs every pass eagerly.
GRAPHS = {"cuda": _CudaGraph}


def _leaves(x, out: list) -> list:
    """The tensor leaves of a state tree (NamedTuples, tuples, dicts, None
    and tensors), in order, appended to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, tuple):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    return out


def _rebuild(x, it):
    """``x``'s tree with its tensor leaves taken from ``it`` in order."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if isinstance(x, tuple):
        vals = [_rebuild(v, it) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: _rebuild(v, it) for k, v in x.items()}
    return x


def _spec(x, shapes: bool = True):
    """The tree's form, with each leaf's dtype, shape and device (or, with
    ``shapes`` off, the form alone)."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, tuple(x.shape), x.device) if shapes else torch.Tensor
    if isinstance(x, tuple):
        return (type(x),) + tuple(_spec(v, shapes) for v in x)
    if isinstance(x, dict):
        return (dict,) + tuple((k, _spec(v, shapes)) for k, v in x.items())
    return type(x)


class _Plan(NamedTuple):
    """What one handler pass does with its input leaves (indices into the
    leaves of ``(st, ev)``)."""

    fixed: tuple    # read and passed through: read at their address
    staged: tuple   # read and replaced: read from a static copy
    out_src: tuple  # per output leaf, the input leaf it passes on, or -1
    back: tuple     # the output leaves copied back into their static copy


# Tensor methods that read a value back to the host.
_HOST_READS = {"__bool__", "__int__", "__float__", "__index__", "item",
               "tolist"}


class _Watch(TorchFunctionMode):
    """The storages an eager pass hands to torch functions and kernels;
    refuses a read back to the host, which no graph can hold."""

    def __init__(self):
        super().__init__()
        self.storages: set = set()

    def see(self, args) -> None:
        for a in args:
            if isinstance(a, torch.Tensor):
                self.storages.add(a.untyped_storage().data_ptr())

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = tree_leaves((args, kwargs))
        self.see(ins)
        if getattr(func, "__name__", None) in _HOST_READS:
            raise RuntimeError(
                "a handler pass marked capturable reads a device value "
                "back to the host: it cannot be replayed as a graph")
        out = func(*args, **kwargs)
        if any(isinstance(a, torch.Tensor) and a.device.type != "cpu"
               for a in ins) and any(
                   isinstance(o, torch.Tensor) and o.device.type == "cpu"
                   for o in tree_leaves(out)):
            raise RuntimeError(
                f"a handler pass marked capturable copies to the host "
                f"({func}): it cannot be replayed as a graph")
        return out


def _learn(fn, st, ev, leaves: list):
    """Run the pass eagerly once, watching which leaves it reads and which
    it passes on. Returns (its plan, its result)."""
    where: dict = {}
    for i, t in enumerate(leaves):
        ptr = t.untyped_storage().data_ptr()
        if ptr:
            where.setdefault(ptr, []).append(i)
    watch = _Watch()
    popk.WATCH.append(watch.see)
    try:
        with watch:
            out = fn(st, ev)
    finally:
        popk.WATCH.remove(watch.see)
    read = {i for ptr in watch.storages for i in where.get(ptr, ())}
    outs = _leaves(out, [])
    pos = {id(t): i for i, t in enumerate(leaves)}
    out_src = tuple(pos.get(id(o), -1) for o in outs)
    through = set(out_src) - {-1}
    staged = tuple(sorted(read - through))
    back = ()
    if _spec(out, False) == _spec(st, False):
        # The output tree is the state's: output j replaces state leaf j.
        back = tuple(j for j in staged if j < len(outs) and out_src[j] < 0
                     and outs[j].shape == leaves[j].shape
                     and outs[j].dtype == leaves[j].dtype)
    return _Plan(fixed=tuple(sorted(read & through)), staged=staged,
                 out_src=out_src, back=back), out


def _take_back(counts: dict, before: dict) -> dict:
    """Reset ``counts`` to ``before``; return what was added since."""
    added = {k: counts[k] - before[k] for k in counts if counts[k] != before[k]}
    counts.update(before)
    return added


class _Pass:
    """One handler pass captured for one input layout and one set of
    plane addresses."""

    def __init__(self, graph_cls, fn, plan: _Plan, tree, leaves: list):
        self.fn, self.plan, self.n = fn, plan, len(leaves)
        # Outputs made in the graph's own memory, which a later capture
        # may reuse: each replay hands on a copy.
        self.fresh = [j for j, i in enumerate(plan.out_src)
                      if i < 0 and j not in plan.back]
        self.fixed = [(i, leaves[i]) for i in plan.fixed]
        self.static = [(i, leaves[i].clone()) for i in plan.staged]
        inputs = list(leaves)
        for i, s in self.static:
            inputs[i] = s
        st_c, ev_c = _rebuild(tree, iter(inputs))
        copy_of = dict(self.static)
        form = []

        def body():
            out = fn(st_c, ev_c)
            outs = _leaves(out, [])
            for j in plan.back:
                copy_of[j].copy_(outs[j])
                outs[j] = copy_of[j]
            if not form:
                form.append(out)
            return outs

        launches, entries = dict(popk.LAUNCHES), dict(popk.PUSH_ENTRIES)
        self.graph = graph_cls(leaves[0].device)
        self.outs = self.graph.capture(body)
        self.form = form[0]
        # The capture ran no kernel: its calls count at each replay.
        self.launches = _take_back(popk.LAUNCHES, launches)
        self.entries = _take_back(popk.PUSH_ENTRIES, entries)

    def fits(self, fn, leaves: list) -> bool:
        """Whether this graph runs ``fn`` on these leaves: the same planes,
        and static copies of the leaves' shapes and dtypes."""
        if fn is not self.fn or len(leaves) != self.n:
            return False
        for i, t in self.fixed:
            if leaves[i] is not t:
                return False
        for i, s in self.static:
            x = leaves[i]
            if x is not s and (x.shape != s.shape or x.dtype != s.dtype):
                return False
        return True

    def replay(self, leaves: list):
        dst, src = [], []
        for i, s in self.static:
            if leaves[i] is not s:
                dst.append(s)
                src.append(leaves[i])
        if dst:
            torch._foreach_copy_(dst, src)
        self.graph.replay()
        for k, n in self.launches.items():
            popk.LAUNCHES[k] += n
        for k, n in self.entries.items():
            popk.PUSH_ENTRIES[k] += n
        outs = [o if i < 0 else leaves[i]
                for i, o in zip(self.plan.out_src, self.outs)]
        for j in self.fresh:
            outs[j] = outs[j].clone()
        return _rebuild(self.form, iter(outs))


# The captured pass of each handler kind.
_PASSES: dict = {}


def run_pass(kind: int, fn, st, ev):
    """``fn(st, ev)`` for a pass marked ``capturable``: a replay of its
    graph, captured first where there is none for these planes; eager on a
    device without graphs, and on the first pass of a layout, which learns
    the plan."""
    graph_cls = GRAPHS.get(ev.mask.device.type)
    if graph_cls is None:
        return fn(st, ev)
    tree = (st, ev)
    leaves = _leaves(tree, [])
    p = _PASSES.get(kind)
    if p is None or not p.fits(fn, leaves):
        # Drop the old graph before the new one is captured.
        _PASSES.pop(kind, None)
        p = None
        key = _spec(tree)
        plan = fn.graph_plans.get(key)
        if plan is None:
            fn.graph_plans[key], st = _learn(fn, st, ev, leaves)
            return st
        with round_span(RS_GRAPH_CAPTURE):
            p = _PASSES[kind] = _Pass(graph_cls, fn, plan, tree, leaves)
    with round_span(RS_GRAPH_REPLAY):
        return p.replay(leaves)


def release() -> None:
    """Drop every captured pass (the round loop's end): no replay rewrites
    a tensor of the state after it."""
    _PASSES.clear()

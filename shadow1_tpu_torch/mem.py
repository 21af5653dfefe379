"""Memory plane — pre-flight device-memory budgeting, the OOM taxonomy,
downshift planning (port of ``mem.py``: the solo engine, the fleet, and
one rank of the sharded engine, ``n_dev``).

* **pre-flight estimator** (:func:`estimate`): the engine state is built on
  ``torch.device("meta")`` through the real model-init path
  (:func:`abstract_state`), so the per-leaf shapes and dtypes are exactly
  ``Engine.init_state``'s and no state-sized allocation happens; a small
  state is built on the host instead (:func:`_init_device`: the same
  shapes, without the meta device's first-use cost). On top of the
  resident state ride the port's own peaks (below).
* **budget check** (:func:`check_budget`): estimate against the device
  budget (:func:`device_budget`: ``SHADOW1_MEM_BYTES`` wins, else what
  this process can still hold on the card — the free bytes
  ``torch.cuda.mem_get_info`` reports plus the caching allocator's
  reserve; none on the CPU, where the estimate is informational). Over
  budget ⇒ :class:`MemoryBudgetError` with per-plane attribution and
  paste-ready advice, before the engine is built.
* **downshift planner** (:func:`downshift`, CLI ``--on-oom downshift``):
  drop the txn rollback copy (``retry`` demotes to ``halt``), then shrink
  the telemetry ring (observability only), then split a fleet into
  sequential sub-batches of the most lanes that fit (``cli._fleet_subbatched``;
  lanes are independent, so each lane's results are the same).
* **runtime taxonomy** (:func:`is_oom`): PyTorch's
  ``torch.cuda.OutOfMemoryError``, the ``CUDA out of memory`` /
  ``CUDA error: out of memory`` texts (a kernel launch's error included)
  and ``MemoryError``; the CLI maps them to ``consts.EXIT_MEMORY``.

**The port's memory contract.** ``planes`` are resident for the run: the
state per plane, the ctx tables (``const``) and, when hosts restart, the
restart capture (``init_model``, a second model state). ``peaks`` are
transients that coexist with them at the worst moment, and are the port's
own (eager PyTorch, not XLA's buffers):

* ``output`` — one full state: a window's input state stays referenced
  while the window builds its output (every eager op returns a fresh
  tensor; on CUDA only the kernels' event-buffer and outbox planes are
  updated in place), so a window can double-hold every leaf. The chunk
  runner hands its state over (``ckpt.run_chunked``) so the chunk-start
  state is not a third copy;
* ``rollback`` — one full state under ``on_overflow=retry``: the guard's
  chunk-start clone (``txn.OverflowGuard.rollback_point``); on a sharded
  rank with no guard and an auto-sized exchange bucket, the input clone
  that ``ShardedEngine.run`` keeps for its retry. During a
  replay the tainted result is freed first, so the rollback copy and the
  replaying state are all there is. A fleet under
  ``on_lane_fail=quarantine`` holds the same clone (``fleet/run.py``
  slices a failing lane out of the chunk-start state), so it is priced
  there too — the serve daemon runs every batch so;
* ``transient`` — the largest per-phase working set: the window end
  (``route_outbox``'s flattened [P·H] columns, ``deliver_batch``'s sort
  keys, ranks and gathered [5+NP, C, H] rows, and its new event-buffer
  planes while the old ones are referenced), the ``rebase`` / evbuf
  digest i64 temporaries over [C, H], and the passes over the largest
  model leaf (a round's TCP passes and the TCP digest's i64 hash words
  over the [Q, S, H] message FIFO — on the H100 the peak of a fidelity16k
  window, ``chip_smoke.py`` phase 14).

The budget compares ``peak_bytes``; the audit compares ``resident_bytes``
with ``torch.cuda.memory_allocated()`` after ``init_state`` (within
:data:`AUDIT_TOLERANCE`), and ``peak_bytes`` must never be below the
measured ``torch.cuda.max_memory_allocated()`` (``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from shadow1_tpu_torch.consts import EXIT_MEMORY, NP  # noqa: F401 (re-export)

# Env override for the device byte budget (integer bytes). Wins over the
# card's reported memory; the deterministic knob the CPU tests use.
MEM_BYTES_ENV = "SHADOW1_MEM_BYTES"

# Estimator vs measured resident bytes: the acceptance bound.
AUDIT_TOLERANCE = 0.10

# Window-end bytes per outbox slot (route_outbox, deliver_flat and the
# deliver_batch keys): the flat mask/src/dst columns, the i64 departure,
# counter, vertex, arrival, threshold, loss-bit and tie-break columns, the
# sort key and its sorted copy, and the stacked [5+NP] i32 rows.
_ROUTE_BYTES_PER_SLOT = 4 * 4 + 14 * 8 + 4 * (5 + NP)
# Window-end bytes per event slot beyond the new planes (deliver_batch):
# the free flag and its i64 rank (with cumsum's copy), the source and
# flat-index gathers, and the gathered [5+NP, C, H] rows.
_DELIVER_BYTES_PER_SLOT = 2 + 4 * 8 + 4 * (5 + NP)
# rebase and the evbuf digest: i64 absolute times and the hash words.
_REBASE_BYTES_PER_SLOT = 8 * 8
# Passes over the largest model leaf, in its bytes: a round's compare
# masks, where-written copy and gathered operand, or the TCP digest's two
# i64 hash-word arrays over an i32 leaf.
_ROUND_LEAF_COPIES = 4

_OOM_TEXTS = ("CUDA out of memory", "CUDA error: out of memory")


class MemoryBudgetError(RuntimeError):
    """The pre-flight byte estimate exceeds the device memory budget.

    Structured: ``estimated`` (peak bytes), ``budget`` (device bytes),
    ``budget_source`` ("env" or "backend"), ``planes`` (resident per-plane
    bytes), ``peaks`` (transient adders), ``advice`` (the paste-ready
    remedy block). Raised before the engine is built."""

    def __init__(self, estimated: int, budget: int, planes: dict,
                 peaks: dict, advice: str, budget_source: str = "env",
                 detail: str = ""):
        self.estimated = int(estimated)
        self.budget = int(budget)
        self.budget_source = budget_source
        self.planes = {k: int(v) for k, v in planes.items()}
        self.peaks = {k: int(v) for k, v in peaks.items()}
        self.advice = advice
        attribution = "  ".join(
            f"{k}={fmt_bytes(v)}" for k, v in
            sorted({**self.planes, **self.peaks}.items(),
                   key=lambda kv: -kv[1]) if v)
        super().__init__(
            f"estimated peak device memory {fmt_bytes(self.estimated)} "
            f"exceeds the {budget_source} budget {fmt_bytes(self.budget)}"
            f"{detail} — rejected before the engine is built (an "
            f"oversubscribed config would otherwise die mid-run with a CUDA "
            f"out-of-memory error). Plane attribution: {attribution}.\n"
            f"{advice}")


def fmt_bytes(n) -> str:
    """Human-readable bytes; None → "?"."""
    if n is None:
        return "?"
    n = int(n)
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"


def is_oom(e: BaseException) -> bool:
    """Is this exception a device out-of-memory condition?

    ``torch.cuda.OutOfMemoryError``, an error whose text is the caching
    allocator's or the CUDA runtime's out-of-memory message (a kernel
    launch of ``core/popk.py`` reports its ``cudaError`` that way too) and
    ``MemoryError``. The structured :class:`MemoryBudgetError` never
    matches: it is handled by type."""
    if isinstance(e, MemoryBudgetError):
        return False
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(e)
    return any(t in msg for t in _OOM_TEXTS)


def is_oom_text(line: str) -> bool:
    """A log line that carries a device out-of-memory error (the
    supervisor's raw-OOM scan of a child's stderr)."""
    return any(t in line for t in _OOM_TEXTS) or "OutOfMemoryError" in line


def device_budget(device=None) -> tuple[int | None, str | None]:
    """The device byte budget: (bytes, source) or (None, None).

    ``SHADOW1_MEM_BYTES`` (integer bytes) wins. Otherwise, on a CUDA
    device (``device``, default the current one when a card is present),
    what this process can still hold: the free bytes of
    ``torch.cuda.mem_get_info`` plus ``torch.cuda.memory_reserved`` (the
    caching allocator's blocks, free or not, are this process's). None on
    the CPU."""
    env = os.environ.get(MEM_BYTES_ENV)
    if env:
        try:
            return int(env), "env"
        except ValueError:
            import sys

            print(f"[mem] ignoring malformed {MEM_BYTES_ENV}={env!r} "
                  f"(integer bytes expected)", file=sys.stderr, flush=True)
    dev = _cuda_device(device)
    if dev is None:
        return None, None
    free, _total = torch.cuda.mem_get_info(dev)
    return int(free) + int(torch.cuda.memory_reserved(dev)), "backend"


def _cuda_device(device):
    if device is None:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else None)
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def device_peak_in_use(device=None) -> int | None:
    """The allocator's measured high-water mark
    (``torch.cuda.max_memory_allocated``) on a CUDA device, else None."""
    dev = _cuda_device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev is not None else None


def _tensors(obj, out: list) -> list:
    """Every tensor reachable through dataclasses, NamedTuples, dicts,
    lists and tuples."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    return out


def storage_ptrs(*trees) -> dict[int, int]:
    """{storage data pointer: bytes} of every tensor in ``trees``: views
    of one storage count once, and an empty storage not at all."""
    out: dict[int, int] = {}
    for t in _tensors(trees, []):
        s = t.untyped_storage()
        if s.data_ptr() and s.nbytes():
            out[s.data_ptr()] = s.nbytes()
    return out


def live_bytes(*trees) -> int:
    """The measured side of the estimator audit. When the trees live on a
    card: ``torch.cuda.memory_allocated`` (every tensor this process holds
    there). On the CPU: the bytes of the unique storages of ``trees``
    (pass the engine's ``ctx`` and state)."""
    ts = _tensors(trees, [])
    cuda = [t for t in ts if t.is_cuda]
    if cuda:
        return int(torch.cuda.memory_allocated(cuda[0].device))
    return sum(storage_ptrs(*ts).values())


def tree_bytes(tree) -> int:
    """Total bytes of every tensor in ``tree`` (meta tensors by shape)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree, []))


# A state of at most this many slot cells (host columns × per-host slots)
# is built on the host for the estimate (:func:`_init_device`): at most a
# few hundred MB for a moment. A process's first op on the meta device
# imports ``torch._dynamo`` (7.0-8.9 s on the H100 machine, 2 s on 8 cores
# here), which every small CLI launch would otherwise pay.
_HOST_INIT_CELLS = 1 << 22


def _init_device(exp, params, fleet=None) -> str:
    """"cpu" when the state the estimate builds is small, else "meta":
    host columns times the per-host slots of the event buffer, the
    outbox, the sockets with their message FIFOs and the apps' per-host
    tables (Tor's circuit table, Bitcoin's per-transaction rows)."""
    cfg = exp.model_cfg
    per_host = (params.ev_cap + params.outbox_cap
                + params.sockets_per_host * (params.msgq_cap + 1)
                + int(cfg.get("ct_cap", 0))
                + np.size(cfg.get("tx_origin", ())))
    cols = exp.n_hosts * (len(fleet[0]) if fleet is not None else 1)
    return "cpu" if cols * per_host <= _HOST_INIT_CELLS else "meta"


def abstract_state(exp, params, fleet=None):
    """(state, ctx) of an ``Engine`` built on ``torch.device("meta")``: the
    model-init path (the restart capture and the handlers' tables
    included) runs on shapes only, so the leaves have exactly
    ``Engine.init_state``'s shapes and dtypes and no state-sized
    allocation happens. The ctx tables are meta tensors too (the host-side
    numpy tables they come from are the config's own); ``const`` is priced
    from their shapes. A small state is built on the host instead
    (:func:`_init_device`): the same shapes and dtypes. ``fleet`` =
    (experiments, max_rounds) builds a ``FleetEngine`` instead (E lanes
    folded onto the host axis)."""
    device = _init_device(exp, params, fleet)
    if fleet is not None:
        from shadow1_tpu_torch.fleet.engine import FleetEngine

        eng = FleetEngine(fleet[0], params, fleet[1], device=device)
    else:
        from shadow1_tpu_torch.core.engine import Engine

        eng = Engine(exp, params, device=device)
    return eng.init_state(), eng.ctx


def _ctx_bytes(ctx) -> int:
    """Bytes of the ctx's device tables (topology, fault plane, fidelity
    knobs, probe index); the restart capture is priced on its own."""
    return sum(tree_bytes(getattr(ctx, f.name)) for f in dataclasses.fields(ctx)
               if f.name != "init_model")


@dataclasses.dataclass
class MemEstimate:
    """The pre-flight memory model of one run configuration (see the module
    docstring for the contract). The budget compares ``peak_bytes``; the
    audit compares ``resident_bytes``."""

    planes: dict
    peaks: dict
    params: object
    evbuf_per_cap: int      # bytes per ev_cap step
    outbox_per_cap: int
    telem_per_w: int        # bytes per ring window
    n_exp: int = 1          # fleet lanes
    n_dev: int = 1          # sharded ranks (the budget is per rank)

    @property
    def state_bytes(self) -> int:
        return sum(v for k, v in self.planes.items()
                   if k not in ("const", "init_model"))

    @property
    def resident_bytes(self) -> int:
        return sum(self.planes.values())

    @property
    def peak_bytes(self) -> int:
        return self.resident_bytes + sum(self.peaks.values())

    def record(self, budget: int | None = None,
               budget_source: str | None = None, **extra) -> dict:
        """The parseable ``mem`` JSONL record (the reference's schema)."""
        rec = {
            "type": "mem",
            "event": "estimate",
            "n_exp": self.n_exp,
            "n_dev": self.n_dev,
            "estimated_state": self.state_bytes,
            "estimated_resident": self.resident_bytes,
            "estimated_peak": self.peak_bytes,
            "budget": budget,
            "budget_source": budget_source,
            "headroom": (int(budget) - self.peak_bytes
                         if budget is not None else None),
            "planes": {k: int(v) for k, v in self.planes.items()},
            "peaks": {k: int(v) for k, v in self.peaks.items()},
        }
        rec.update(extra)
        return rec

    def advice(self, budget: int) -> str:
        """Paste-ready remedy block: ranked plane attribution and concrete
        knob values by linear scaling (evbuf ∝ ev_cap, ring ∝ W)."""
        from shadow1_tpu_torch.tune.ladder import LADDER_MIN, cap_ladder

        budget = int(budget)
        over = self.peak_bytes - budget
        p = self.params
        lines = [f"Peak over budget by {fmt_bytes(over)}. Remedies "
                 f"(largest planes first):"]
        ranked = sorted({**self.planes, **self.peaks}.items(),
                        key=lambda kv: -kv[1])
        lines.append("  planes: " + ", ".join(
            f"{k} {fmt_bytes(v)}" for k, v in ranked if v))
        if self.peaks.get("rollback") and p.on_overflow == "retry":
            lines.append(f"  --on-overflow halt  # frees the transactional "
                         f"rollback copy: {fmt_bytes(self.peaks['rollback'])}")
        if self.planes.get("telem"):
            spare = budget - (self.peak_bytes - self.planes["telem"])
            w_fit = max(spare, 0) // max(self.telem_per_w, 1)
            if 0 < w_fit < p.metrics_ring:
                lines.append(f"  --metrics-ring {w_fit}  # ring "
                             f"{p.metrics_ring}→{w_fit} windows frees "
                             f"{fmt_bytes((p.metrics_ring - w_fit) * self.telem_per_w)}")
        # Cap ladder-down: the largest ladder cap whose scaled peak fits;
        # a plane counts twice (its resident copy and the output copy).
        eng_lines = []
        residual = self.peak_bytes
        for knob, cur, per in (("ev_cap", p.ev_cap, self.evbuf_per_cap),
                               ("outbox_cap", p.outbox_cap,
                                self.outbox_per_cap)):
            ladder = [c for c in cap_ladder(cur) if LADDER_MIN <= c < cur]
            pick = None
            for cap in reversed(ladder):
                pick = cap
                if residual - 2 * (cur - cap) * per <= budget:
                    break
            if pick is not None:
                residual -= 2 * (cur - pick) * per
                eng_lines.append(f"    {knob}: {pick}  # from {cur}")
        if eng_lines and residual <= budget:
            lines.append("  engine:  # size precisely from a recorded "
                         "run: python -m shadow1_tpu_torch.tools.captune")
            lines.extend(eng_lines)
        lines.append("  or rerun with --on-oom downshift (rollback drop → "
                     "ring shrink → fleet sub-batches, in that order)")
        return "\n".join(lines)


def estimate(exp, params, fleet=None, n_dev: int = 1) -> MemEstimate:
    """The pre-flight byte estimate of one rank's run: solo, or with
    ``fleet`` = (experiments, max_rounds) a fleet, whose lanes fold onto
    the host axis, so every per-host term scales with E·H. ``n_dev`` > 1
    prices one rank of the sharded engine (``shard/engine.py``), as the
    reference does: the planes on the host axis (evbuf, outbox, model, the
    CPU clock, the restart capture, the window-end transients) divide
    across the ranks, the metrics, the telemetry planes and the ctx
    tables do not, and the exchange's send and receive buffers are a
    peak. The state side is exact (the meta-device init); the const side
    is the ctx's tables; the peaks follow the module's memory contract."""
    st, ctx = abstract_state(exp, params, fleet)
    d = max(int(n_dev), 1)

    def sharded(n):  # a host-axis plane, divided across the ranks
        return -(-int(n) // d)

    per = {f: tree_bytes(getattr(st, f))
           for f in ("evbuf", "outbox", "model", "metrics", "telem",
                     "probes", "links")}
    planes = {
        "evbuf": sharded(per["evbuf"]),
        "outbox": sharded(per["outbox"]),
        "model": sharded(per["model"]),
        "metrics": per["metrics"],
        "telem": per["telem"],
        "scalars": sharded(tree_bytes(st.cpu_busy))
        + tree_bytes(st.win_start),
        "const": _ctx_bytes(ctx),
    }
    for f in ("probes", "links"):
        if per[f]:
            planes[f] = per[f]
    if ctx.has_restart:
        planes["init_model"] = sharded(per["model"])
    state = sum(v for k, v in planes.items()
                if k not in ("const", "init_model"))
    h = sharded(ctx.n_hosts)
    window_end = (params.outbox_cap * h * _ROUTE_BYTES_PER_SLOT
                  + params.ev_cap * h * _DELIVER_BYTES_PER_SLOT
                  + planes["evbuf"])
    rebase = params.ev_cap * h * _REBASE_BYTES_PER_SLOT
    leaves = _tensors(st.model, [])
    biggest = sharded(max((t.numel() * t.element_size() for t in leaves),
                          default=0))
    # The sharded engine's own safety net (``ShardedEngine.run``) keeps a
    # clone of its input while an auto-sized bucket may retry: no explicit
    # ``x2x_cap``, an auto cap below the full one (D > 2), and no guard,
    # which runs its chunks with ``check_x2x=False``.
    full_cap = params.outbox_cap * h
    x2x_clone = (d > 1 and not params.x2x_cap
                 and params.on_overflow not in ("retry", "halt")
                 and max(16, -(-2 * full_cap // d)) < full_cap)
    peaks = {
        "output": state,
        "rollback": state if (params.on_overflow == "retry" or x2x_clone or (
            fleet is not None and params.on_lane_fail == "quarantine"))
        else 0,
        "transient": max(window_end, rebase, _ROUND_LEAF_COPIES * biggest),
    }
    if d > 1:
        # The exchange: the [N, 6+NP] packet rows and the [D, K, 7+NP]
        # send and receive buffers at the bucket's guaranteed-fit cap K
        # (the rank's whole outbox), where an overflow's retry ends.
        peaks["x2x"] = 4 * full_cap * ((6 + NP) + 2 * d * (7 + NP))
    return MemEstimate(
        planes=planes, peaks=peaks, params=params,
        evbuf_per_cap=planes["evbuf"] // max(params.ev_cap, 1),
        outbox_per_cap=planes["outbox"] // max(params.outbox_cap, 1),
        telem_per_w=(per["telem"] // params.metrics_ring
                     if params.metrics_ring else 0),
        n_exp=ctx.n_exp or 1, n_dev=d)


def check_budget(est: MemEstimate, budget: int | None,
                 budget_source: str | None = None, detail: str = "") -> None:
    """Raise :class:`MemoryBudgetError` when the estimated peak exceeds the
    budget. A None budget (the CPU, no env override) checks nothing."""
    if budget is None or est.peak_bytes <= int(budget):
        return
    raise MemoryBudgetError(
        estimated=est.peak_bytes, budget=budget, planes=est.planes,
        peaks=est.peaks, advice=est.advice(budget),
        budget_source=budget_source or "env", detail=detail)


def max_lanes(exp, params, fleet, budget: int) -> int:
    """The most leading lanes of ``fleet`` = (experiments, max_rounds)
    whose estimated peak fits ``budget`` (0 when not even one does): the
    estimate grows with the lane count, so a bisection finds it."""
    exps, mr = fleet
    lo, hi = 0, len(exps)
    while lo < hi:
        k = (lo + hi + 1) // 2
        if estimate(exp, params, (exps[:k], mr and mr[:k])).peak_bytes \
                <= budget:
            lo = k
        else:
            hi = k - 1
    return lo


def downshift(exp, params, budget: int, resumable: bool = False,
              fleet=None, subbatch_resumable: bool = False, n_dev: int = 1):
    """The graceful-degradation planner (CLI ``--on-oom downshift``).

    Applies the bit-exactness-preserving downshifts IN ORDER until the
    estimated peak fits ``budget``:

    1. **drop the rollback copy** — ``on_overflow=retry`` demotes to
       ``halt`` (a replay needs the copy; halt keeps overflow loud);
    2. **shrink the telemetry ring** — the simulation never reads it, so a
       narrower W changes which windows get records, never a digest word
       that is recorded (``state_digest`` keeps W ≥ 1). Skipped when
       ``resumable`` (--ckpt/--resume/--save-state): the ring is a state
       leaf, and a snapshot must load at the config's width.

    3. **sub-batch a fleet** (``fleet`` = (experiments, max_rounds)) —
       run its E lanes as sequential batches of the most lanes that fit
       (the ``sub_batch`` action's ``lanes``; ``cli._fleet_subbatched``).
       Lanes never read one another's columns, so each lane's results are
       those of the full fleet. It composes with ``--ckpt``
       (``subbatch_resumable``: each batch snapshots its own lanes, the
       batch cursor rides the lineage manifest), not with an explicit
       ``--resume`` / ``--save-state`` path, which names one snapshot of
       every lane.

    ``n_dev`` prices one rank of a sharded run (:func:`estimate`).

    Returns ``(params', actions)``; raises :class:`MemoryBudgetError` when
    the stages are exhausted."""
    budget = int(budget)
    actions: list[dict] = []
    est = estimate(exp, params, fleet, n_dev)
    if est.peak_bytes <= budget:
        return params, actions
    if params.on_overflow == "retry":
        params = dataclasses.replace(params, on_overflow="halt")
        halted = estimate(exp, params, fleet, n_dev)
        # A quarantining fleet keeps its chunk-start clone under halt.
        actions.append({"action": "drop_rollback", "on_overflow": "halt",
                        "freed": int(est.peak_bytes - halted.peak_bytes)})
        est = halted
    if est.peak_bytes > budget and params.metrics_ring > 0 and not resumable:
        min_w = 1 if params.state_digest else 0
        # A removed ring window frees its row in the state and in the
        # output copy: 2 × telem_per_w. One more exact pass handles any
        # rounding shortfall.
        row = 2 * max(est.telem_per_w, 1)
        w0 = w_new = params.metrics_ring
        for _ in range(2):
            need = est.peak_bytes - budget
            if need <= 0 or w_new <= min_w:
                break
            w_new = max(min_w, w_new - math.ceil(need / row))
            params = dataclasses.replace(params, metrics_ring=w_new)
            est = estimate(exp, params, fleet, n_dev)
        if w_new < w0:
            actions.append({"action": "shrink_ring",
                            "metrics_ring": [w0, w_new],
                            "freed": int((w0 - w_new) * row)})
    if est.peak_bytes > budget and fleet is not None and len(fleet[0]) > 1:
        k = max_lanes(exp, params, fleet, budget)
        if 1 <= k < len(fleet[0]):
            if resumable and not subbatch_resumable:
                raise MemoryBudgetError(
                    estimated=est.peak_bytes, budget=budget,
                    planes=est.planes, peaks=est.peaks,
                    advice=est.advice(budget),
                    detail=" (sub-batched downshift does not compose with "
                           "an explicit --resume/--save-state snapshot "
                           "path, which names one state of every lane and "
                           "carries no batch cursor; use --ckpt, whose "
                           "lineage manifest records it, or shrink the "
                           "sweep)")
            actions.append({"action": "sub_batch", "lanes": k,
                            "batches": -(-len(fleet[0]) // k)})
            est = estimate(exp, params, (fleet[0][:k],
                                         fleet[1] and fleet[1][:k]))
    if est.peak_bytes > budget:
        detail = (" (the state-shape-preserving downshift is exhausted: "
                  "rollback dropped — ring shrink is unavailable under "
                  "--ckpt/--resume/--save-state because it changes the "
                  "snapshot shape; drop the checkpoint flags or shrink the "
                  "config)" if resumable else
                  " (every --on-oom downshift is exhausted: rollback "
                  "dropped, ring floored — the base state planes alone "
                  "exceed the device)")
        raise MemoryBudgetError(
            estimated=est.peak_bytes, budget=budget, planes=est.planes,
            peaks=est.peaks, advice=est.advice(budget), detail=detail)
    return params, actions


def downshift_record(actions: list[dict], est_peak: int,
                     budget: int) -> dict:
    """The parseable ``mem`` downshift record."""
    return {"type": "mem", "event": "downshift", "actions": actions,
            "estimated_peak": int(est_peak), "budget": int(budget)}

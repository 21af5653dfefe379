"""Transactional overflow plane — recoverable capacity overflow (port of
``txn.py``, solo engine).

The determinism contract holds only for overflow-free runs: WHICH events
drop when a bounded buffer fills is layout-defined, so one burst past
``ev_cap`` silently forks a run away from its big-cap truth. This module
turns that condition into a policy applied at chunk boundaries
(``ckpt.run_chunked``):

* ``drop`` (default) — overflow is counted, the run continues;
* ``retry`` — chunks are **transactional**: when a chunk's fresh overflow
  deltas are non-zero, the tainted result is discarded, the offending cap
  grows one ladder step (``tune/ladder.py``; bit-exact plane migration,
  ``tune/resize.py``) and the SAME chunk re-runs from the chunk-start
  state on the engine at the grown caps. Counter-based RNG and
  window-indexed fault tables make the replay exact, so a retried run's
  digest stream equals a straight run at the final caps. Growing
  ``outbox_cap`` is bit-exact only for models whose outbox use is
  drop-counted (TCP paces on ``outbox_space``);
* ``halt`` — raise :class:`CapacityExceededError`, carrying the offending
  knob, window range and paste-ready cap advice; the CLI maps it to
  ``EXIT_CAPACITY``, which the supervisor never respawns.

**The rollback point is a clone.** The reference keeps the chunk-start
state by reference, free because JAX arrays are immutable. Here the CUDA
kernels update the event-buffer and outbox planes of the state they are
given in place, so :meth:`OverflowGuard.rollback_point` takes a device
copy of every leaf before the chunk runs, and a replay starts from a fresh
clone of that copy (the copy itself survives for a second attempt).

Also here: the in-run self-check (``--selfcheck``): the drop-accounting
identity checked at every committed chunk boundary
(:func:`check_boundary_identity`).

A fleet state (``fleet/engine.py``) is one transaction unit: its
overflow counters are ``[E]``, any lane's fresh overflow taints the chunk,
and the caps stay fleet-uniform; ``fresh_by_lane`` names the lanes, which
``CapacityExceededError.lanes`` carries to the fleet runner.

The sharded engine's exchange bucket (``x2x_cap``, ``shard/engine.py``)
is not a state shape: a chunk whose ``x2x_overflow`` grew escalates the
bucket through ``engine.grow_x2x()`` and replays, with no plane migration.
A sharded chunk runs with ``check_x2x=False`` (:meth:`OverflowGuard.
run_guarded`), so the engine's own safety net leaves the response to the
guard.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shadow1_tpu_torch.consts import EXIT_CAPACITY  # noqa: F401 (re-export)

# Overflow counter → the capacity knob whose growth recovers it.
OVERFLOW_KNOBS: dict[str, str] = {
    "ev_overflow": "ev_cap",
    "ob_overflow": "outbox_cap",
    "x2x_overflow": "x2x_cap",
}

# knob → the high-water gauge that lower-bounds the demanded capacity.
_KNOB_GAUGE = {
    "ev_cap": "ev_max_fill",
    "outbox_cap": "ob_max_fill",
    "x2x_cap": "x2x_max_fill",
}


class CapacityExceededError(RuntimeError):
    """A capacity knob overflowed under a policy that forbids silent loss.

    Structured: ``knob`` (the EngineParams field), ``counter`` (the
    overflow metric), ``cap`` (the value that overflowed), ``overflow``
    (fresh drops attributed to it), ``window_range`` (``[w0, w1)`` window
    indices of the tainted chunk), ``recommended`` (ladder-quantized cap
    that would have held), ``advice`` (a paste-ready ``engine:`` YAML
    block) and, in a fleet, ``lanes`` (the LOCAL lane indices whose
    counter overflowed, what ``--on-lane-fail quarantine`` slices out)."""

    def __init__(self, knob: str, counter: str, cap: int, overflow: int,
                 window_range: tuple[int, int], recommended: int | None = None,
                 detail: str = "", lanes: list[int] | None = None):
        self.knob = knob
        self.counter = counter
        self.cap = int(cap)
        self.overflow = int(overflow)
        self.window_range = (int(window_range[0]), int(window_range[1]))
        self.lanes = list(lanes) if lanes is not None else None
        if recommended is None:
            from shadow1_tpu_torch.tune.ladder import next_step

            recommended = next_step(cap)
        self.recommended = int(recommended)
        self.advice = f"engine:\n  {knob}: {self.recommended}"
        super().__init__(
            f"{counter}: {self.overflow} overflow drop(s) in windows "
            f"[{self.window_range[0]}, {self.window_range[1]}) at "
            f"{knob}={self.cap}{detail} — which items drop on overflow is "
            f"layout-defined, so the run has forked from its big-cap truth "
            f"(docs/SEMANTICS.md 'Capacities'). Paste-ready fix:\n"
            f"{self.advice}\n"
            "or rerun with --on-overflow retry (transactional grow+replay) "
            "/ --auto-caps; size precisely from a recorded run: python -m "
            "shadow1_tpu_torch.tools.captune <run.log>")


class SelfCheckError(RuntimeError):
    """The drop-accounting identity failed at a chunk boundary.

    Structured: ``terms`` (every counter in the identity with its value),
    ``gap`` (signed packets unaccounted: positive = ``pkts_sent`` exceeds
    every accounted sink, negative = the sinks over-explain), ``where``."""

    IDENTITY = ("pkts_sent == pkts_delivered + pkts_lost + link_down_pkts "
                "+ down_pkts + x2x_overflow (+ delivery share of ev_overflow)")

    def __init__(self, terms: dict, gap: int, where: str = ""):
        self.terms = {k: int(v) for k, v in terms.items()}
        self.gap = int(gap)
        self.where = where
        if gap > 0:
            culprit = (f"pkts_sent exceeds every accounted sink by {gap} — "
                       f"a drop/delivery path went uncounted")
        else:
            culprit = (f"the accounted sinks exceed pkts_sent by {-gap} — "
                       f"a packet was counted twice")
        span = f" at {where}" if where else ""
        super().__init__(
            f"drop-accounting self-check violated{span}: {culprit}. "
            f"Identity: {self.IDENTITY}. Terms: {self.terms}. "
            f"Bisect the window with tools/paritytrace.py; "
            f"cross-engine verdict: tools/churnprobe.py")


def accounting(m: dict) -> dict:
    """The drop-accounting identity: where every sent packet went.
    ``ev_overflow`` counts event-buffer drops from local pushes and
    deliveries; only the delivery share belongs here, so the identity is
    checked as sent ≤ explained ≤ sent + ev_overflow (exact when
    ev_overflow == 0)."""
    explained = (m["pkts_delivered"] + m["pkts_lost"] + m["link_down_pkts"]
                 + m["down_pkts"] + m.get("x2x_overflow", 0))
    lo, hi = explained, explained + m["ev_overflow"]
    return {
        "pkts_sent": m["pkts_sent"],
        "explained": explained,
        "ev_overflow": m["ev_overflow"],
        "closes": lo <= m["pkts_sent"] <= hi,
    }


_IDENTITY_TERMS = ("pkts_sent", "pkts_delivered", "pkts_lost",
                   "link_down_pkts", "down_pkts", "x2x_overflow",
                   "ev_overflow")


def check_boundary_identity(metrics: dict, where: str = "") -> None:
    """Raise :class:`SelfCheckError` if the cumulative counters in
    ``metrics`` fail the drop-accounting identity. Missing counters read
    as 0."""
    m = {k: int(metrics.get(k, 0)) for k in _IDENTITY_TERMS}
    acc = accounting(m)
    if acc["closes"]:
        return
    raise SelfCheckError(m, m["pkts_sent"] - acc["explained"], where=where)


class OverflowGuard:
    """The chunk-boundary transactional brain (``--on-overflow``).

    Construct with the running engine, a ``params -> engine`` factory
    (sibling engines at grown caps), and the mode. ``run_chunked`` calls
    :meth:`bind` once (overflow baselines from the possibly-resumed
    state), :meth:`rollback_point` before every chunk and :meth:`commit`
    after it; commit accepts the chunk (no fresh overflow), replays it at
    grown caps (``retry``), or raises :class:`CapacityExceededError`
    (``halt``, ladder exhaustion, or too many attempts at one chunk).

    With a ``tune.CapController`` attached, the guard builds its engines
    through the controller's cache and reports every retry-driven grow via
    ``controller.note_lossy``, so the two planes never double-grow or
    oscillate."""

    def __init__(self, engine, make_engine=None, mode: str = "retry",
                 controller=None, log=None, max_cap: int = 1 << 20,
                 max_retries_per_chunk: int = 12):
        assert mode in ("retry", "halt"), mode
        self.mode = mode
        self.engine = engine
        self._make_engine = make_engine
        self._controller = controller
        self._engines: dict = {}
        self._seen: dict[str, int] | None = None
        self._log = log
        self.max_cap = max_cap
        self.max_retries = max_retries_per_chunk
        self.chunk_retries = 0
        self.retry_windows_rerun = 0
        self.resizes: list[dict] = []  # audit log (CLI retries block / tests)
        self.on_engine_swap = None     # hook: heartbeat tracks the live engine

    # -- lifecycle ---------------------------------------------------------
    def bind(self, engine, st) -> None:
        """Baseline the overflow counters from ``st`` (a resumed state
        carries its pre-snapshot losses, which are not a fresh lossy
        chunk)."""
        self.engine = engine
        self._seen = self._counters(st)

    @staticmethod
    def run_guarded(engine, held: list, n_windows: int):
        """Run one chunk under the guard from the state popped off
        ``held`` (its only reference): the sharded engine's eager exchange
        safety net stands down (``check_x2x=False``), since the guard owns
        the overflow response. ``ckpt.run_chunked`` and the replay both
        run chunks so. The state goes straight into ``engine.run``, which
        rebinds it window by window: no frame here keeps the chunk-start
        state alive (a call through ``**kwargs`` would, in its argument
        tuple)."""
        return engine.run(held.pop(), n_windows=n_windows, check_x2x=False)

    @staticmethod
    def _counters(st) -> dict:
        """Cumulative overflow counters as numpy arrays: 0-d on a solo
        state, [E] on a fleet's, so one guard serves both (the fleet's
        total is the lane sum; the lanes stay for ``fresh_by_lane``)."""
        return {c: getattr(st.metrics, c).cpu().numpy().astype(np.int64)
                for c in OVERFLOW_KNOBS}

    def rollback_point(self, st):
        """The chunk-start state to roll back to: a device copy of every
        leaf, taken before the chunk runs (the CUDA kernels write the
        planes of the state they are given in place). Under ``halt`` no
        chunk is replayed and nothing is kept."""
        if self.mode == "halt":
            return None
        from shadow1_tpu_torch.convert import clone_state

        return clone_state(st)

    def _fresh(self, st) -> dict[str, int]:
        cur = self._counters(st)
        out = {}
        for c, v in cur.items():
            d = int((v - self._seen[c]).sum())
            if d > 0:
                out[c] = d
        return out

    def fresh_by_lane(self, st) -> dict[str, list[int]]:
        """Fleet attribution: LOCAL lane indices with fresh overflow per
        counter since the last bind or commit ({} on a solo state)."""
        out: dict[str, list[int]] = {}
        for c, v in self._counters(st).items():
            if v.ndim == 0:
                continue
            lanes = np.nonzero(v - self._seen[c] > 0)[0]
            if lanes.size:
                out[c] = [int(e) for e in lanes]
        return out

    # -- the transaction ---------------------------------------------------
    def commit(self, engine, st0, st, done: int, step: int):
        """Accept / replay / refuse one chunk. ``st0`` is the rollback
        point (:meth:`rollback_point` of the chunk-start state), ``st`` the
        chunk's result. Returns the committed ``(engine, state)``. The
        caller hands both over: a replay frees the tainted result before
        it runs, so at most the rollback copy and the running chunk's
        state are alive."""
        if self._seen is None:
            raise RuntimeError("OverflowGuard.commit before bind")
        fresh = self._fresh(st)
        attempts = 0
        while fresh:
            w0 = int(st.win_start.max()) // engine.window - step
            if self.mode == "halt":
                raise self._error(engine, fresh, w0, w0 + step, st)
            attempts += 1
            if attempts > self.max_retries:
                raise self._error(
                    engine, fresh, w0, w0 + step, st,
                    detail=(f" after {attempts - 1} grow+replay attempts at "
                            f"the same chunk — growing caps is not fixing "
                            f"it; diagnose with tools/occprobe.py or "
                            f"tools/paritytrace.py"))
            self.chunk_retries += 1
            self.retry_windows_rerun += step
            engine, st0 = self._grow(engine, st0, fresh, w0, w0 + step, st,
                                     lanes=self.fresh_by_lane(st) or None)
            st = None  # the tainted chunk goes before the replay runs
            # The clone is the call's only reference: its leaves go as the
            # replay's windows replace them.
            st = self.run_guarded(engine, [self.rollback_point(st0)], step)
            fresh = self._fresh(st)
        self._seen = self._counters(st)
        self.engine = engine
        return engine, st

    # -- growth ------------------------------------------------------------
    def _engine_for(self, params):
        if self._controller is not None:
            return self._controller.engine_for(params)
        key = (params.ev_cap, params.outbox_cap)
        eng = self._engines.get(key)
        if eng is None:
            if self._make_engine is None:
                raise ValueError(
                    "OverflowGuard(mode='retry') needs a make_engine "
                    "factory (or an attached CapController) to build the "
                    "engine at grown caps")
            eng = self._engines[key] = self._make_engine(params)
        return eng

    def _grow(self, engine, st0, fresh, w0, w1, st_tainted, lanes=None):
        from shadow1_tpu_torch.tune.ladder import next_step
        from shadow1_tpu_torch.tune.resize import resize_state

        params = engine.params
        repl: dict[str, int] = {}
        rec: dict = {"windows": [w0, w1], "retry": self.chunk_retries}
        if lanes:
            # Fleet retry audit: which lanes' counters tainted this chunk.
            rec["lanes"] = lanes
        for ctr, knob in OVERFLOW_KNOBS.items():
            if ctr not in fresh:
                continue
            if knob == "x2x_cap":
                # The bucket's guaranteed-fit cap is the rank's whole
                # outbox: a False means the overflow is not bucket-sized.
                old = getattr(engine, "_x2x_cap", None)
                if not engine.grow_x2x():
                    raise self._error(engine, {ctr: fresh[ctr]}, w0, w1,
                                      st_tainted,
                                      detail=" (exchange bucket already at "
                                             "its guaranteed-fit cap)")
                rec["x2x_cap"] = [old, engine._x2x_cap]
                continue
            cap = getattr(params, knob)
            new = next_step(cap)
            if new > self.max_cap:
                raise self._error(
                    engine, {ctr: fresh[ctr]}, w0, w1, st_tainted,
                    detail=f" (ladder top: cannot grow past {self.max_cap})")
            repl[knob] = new
            rec[knob] = [cap, new]
            if self._controller is not None:
                self._controller.note_lossy(knob, new)
        if repl:
            new_params = dataclasses.replace(params, **repl)
            engine = self._engine_for(new_params)
            st0 = resize_state(st0, ev_cap=new_params.ev_cap,
                               outbox_cap=new_params.outbox_cap)
        self.resizes.append(rec)
        if self.on_engine_swap is not None:
            self.on_engine_swap(engine)
        if self._log is not None:
            self._log("overflow retry: chunk discarded, caps grown", **rec)
        return engine, st0

    def _error(self, engine, fresh, w0, w1, st, detail=""):
        from shadow1_tpu_torch.tune.ladder import next_step, recommend_cap

        counter = max(fresh, key=lambda c: fresh[c])
        knob = OVERFLOW_KNOBS[counter]
        cap = 0 if knob == "x2x_cap" else getattr(engine.params, knob)
        # The max over lanes: the scalar on a solo state.
        peak = int(getattr(st.metrics, _KNOB_GAUGE[knob]).max())
        rec = max(next_step(cap), recommend_cap(peak) if peak else 0)
        lanes = self.fresh_by_lane(st).get(counter) if self._seen else None
        if lanes:
            detail = f" (fleet lane(s) {lanes})" + detail
        return CapacityExceededError(
            knob=knob, counter=counter, cap=cap, overflow=fresh[counter],
            window_range=(w0, w1), recommended=rec, detail=detail,
            lanes=lanes)

    # -- reporting ---------------------------------------------------------
    @property
    def final_caps(self) -> dict:
        return {"ev_cap": self.engine.params.ev_cap,
                "outbox_cap": self.engine.params.outbox_cap}

    def report(self) -> dict:
        """The ``retries`` block (heartbeat / final JSON)."""
        return {
            "policy": self.mode,
            "chunk_retries": self.chunk_retries,
            "retry_windows_rerun": self.retry_windows_rerun,
            "caps": self.final_caps,
        }

"""Between-chunk adaptive capacity controller, the ``--auto-caps`` brain
(port of ``tune/autocap.py``).

At every chunk boundary the controller compares the run-max fill gauges
(``Metrics.ev_max_fill`` / ``ob_max_fill``) against the current caps:

* **grow before overflow**: a high-water above ``grow_frac · cap`` means
  the buffer is nearing its ceiling; the next chunk runs at the ladder
  step covering ``high_water × headroom``;
* **shrink after sustained low occupancy**: once the quantized target has
  sat below the current cap for ``shrink_patience`` consecutive chunks,
  the cap drops to the target. The floor is the RUN-MAX fill, so a past
  peak keeps its headroom and the caps cannot oscillate.

Resizes migrate the state's planes bit-exactly on its device
(``tune/resize.py``) and swap to an engine built at the new caps. Engines
are cached per cap pair, as the reference caches its jitted programs:
here a rebuild costs the host-side ``build_base_ctx`` (Tor's and the
fault plane's tables, the restart capture), not a compile.

``outbox_cap`` tuning is OFF by default: outbox space is a semantic knob
for TCP (``tcp_flush`` paces sends on ``outbox_space``), so resizing it
mid-run changes the event stream. Enable ``CapPolicy(tune_outbox=True)``
only for models whose outbox use is drop-counted (PHOLD).
"""

from __future__ import annotations

import dataclasses
import math

from shadow1_tpu_torch.tune.ladder import HEADROOM, next_step, quantize_cap


@dataclasses.dataclass(frozen=True)
class CapPolicy:
    grow_frac: float = 0.75    # grow when high_water > grow_frac * cap
    headroom: float = HEADROOM # target cap = quantize(high_water * headroom)
    shrink_patience: int = 2   # consecutive low chunks before a shrink
    min_cap: int = 8           # never shrink below (ladder anchor)
    max_cap: int = 1 << 20     # never grow beyond (runaway guard)
    tune_outbox: bool = False  # semantic for TCP — see module docstring


class CapController:
    """The ``retune`` hook for ``ckpt.run_chunked``: ``(engine, st) ->
    (engine, st)``. Construct with the running engine and a factory that
    builds its sibling at other caps (``params -> engine``)."""

    def __init__(self, engine, make_engine, policy: CapPolicy | None = None,
                 log=None, initial_state=None):
        self.policy = policy or CapPolicy()
        self._make_engine = make_engine
        self._engines = {self._key(engine.params): engine}
        self._low_chunks = {"ev_cap": 0, "outbox_cap": 0}
        # Overflow backstop baselines: a resumed state carries its
        # pre-snapshot losses in the cumulative counters, which must not
        # read as a fresh lossy chunk.
        m = initial_state.metrics if initial_state is not None else None
        self._overflow_seen = {
            "ev_cap": int(m.ev_overflow.sum()) if m is not None else 0,
            "outbox_cap": int(m.ob_overflow.sum()) if m is not None else 0,
        }
        # Lossless floor: once a cap has overflowed, the shrink target
        # ratchets above it.
        self._floor = {"ev_cap": self.policy.min_cap,
                       "outbox_cap": self.policy.min_cap}
        self.resizes: list[dict] = []   # audit log (CLI output / tests)
        self._log = log

    @staticmethod
    def _key(params):
        return (params.ev_cap, params.outbox_cap)

    def engine_for(self, params):
        """The cached engine at ``params``' caps, built on first use; the
        overflow guard (``txn.OverflowGuard``) builds its grown-cap engines
        through here, so the two planes share one cache."""
        k = self._key(params)
        eng = self._engines.get(k)
        if eng is None:
            eng = self._engines[k] = self._make_engine(params)
        return eng

    def note_lossy(self, knob: str, grown_cap: int) -> None:
        """Absorb a retry-driven grow: the pre-grow cap is proven lossy, so
        the shrink floor ratchets to the grown cap and the low-occupancy
        streak resets. The overflow baseline is not advanced: the tainted
        chunk's counters were discarded with its state."""
        self._floor[knob] = max(self._floor[knob], int(grown_cap))
        self._low_chunks[knob] = 0

    def _decide(self, knob: str, high_water: int, cap: int) -> int:
        p = self.policy
        if high_water <= 0:
            return cap
        target = min(max(quantize_cap(math.ceil(high_water * p.headroom)),
                         p.min_cap, self._floor[knob]), p.max_cap)
        if high_water > p.grow_frac * cap:
            self._low_chunks[knob] = 0
            return max(target, min(next_step(cap), p.max_cap))
        if target < cap:
            self._low_chunks[knob] += 1
            if self._low_chunks[knob] >= p.shrink_patience:
                self._low_chunks[knob] = 0
                return target
            return cap
        self._low_chunks[knob] = 0
        return cap

    def _overflow_grow(self, knob: str, total: int, cap: int,
                       decided: int) -> int:
        """Backstop: the gauges are window-end samples, so a buffer can
        overflow mid-window while its gauge sits below the grow threshold;
        any new overflow forces at least one ladder step up."""
        fresh = total - self._overflow_seen[knob]
        self._overflow_seen[knob] = total
        if fresh <= 0:
            return decided
        self._low_chunks[knob] = 0
        grown = min(next_step(cap), self.policy.max_cap)
        self._floor[knob] = max(self._floor[knob], grown)
        return max(decided, grown)

    def __call__(self, engine, st):
        from shadow1_tpu_torch.tune.resize import resize_state

        params = engine.params
        m = st.metrics
        # Fleet-global gauges (a fleet's are [E]): the max fill over lanes
        # (caps are uniform, the busiest lane sets the floor) and the
        # summed overflow; on a solo state both are the scalar itself.
        ev_hw, ob_hw = int(m.ev_max_fill.max()), int(m.ob_max_fill.max())
        new_ev = self._decide("ev_cap", ev_hw, params.ev_cap)
        new_ev = self._overflow_grow("ev_cap", int(m.ev_overflow.sum()),
                                     params.ev_cap, new_ev)
        new_ob = params.outbox_cap
        if self.policy.tune_outbox:
            new_ob = self._decide("outbox_cap", ob_hw, params.outbox_cap)
            new_ob = self._overflow_grow("outbox_cap", int(m.ob_overflow.sum()),
                                         params.outbox_cap, new_ob)
        if (new_ev, new_ob) == (params.ev_cap, params.outbox_cap):
            return engine, st
        st = resize_state(st, ev_cap=new_ev, outbox_cap=new_ob)
        new_engine = self.engine_for(
            dataclasses.replace(params, ev_cap=new_ev, outbox_cap=new_ob))
        rec = {
            "windows_done": int(m.windows.max()),
            "ev_cap": [params.ev_cap, new_ev],
            "outbox_cap": [params.outbox_cap, new_ob],
            "ev_max_fill": ev_hw,
            "ob_max_fill": ob_hw,
        }
        self.resizes.append(rec)
        if self._log is not None:
            self._log("auto-caps resize", **rec)
        return new_engine, st

    @property
    def final_caps(self) -> dict:
        last = self.resizes[-1] if self.resizes else None
        return ({"ev_cap": last["ev_cap"][1],
                 "outbox_cap": last["outbox_cap"][1]} if last else {})

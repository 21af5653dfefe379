"""Hot engine cache — the daemon's reason to stay alive (port of
``serve/cache.py``).

A long-lived daemon keeps built ``FleetEngine`` objects, keyed by
everything that fixes an engine's structure:

* the **shape class** of the experiment — every ``CompiledExperiment``
  field outside the fleet-variable set (host count, topology latency /
  jitter / bandwidth tables, model + model_cfg, fidelity knobs, horizon):
  the fields ``fleet.expand.check_uniform`` pins, because they pick
  tensor shapes or become the ctx's device tables, with ``model_cfg``
  whole: an app's per-lane entries (Bitcoin's seed-drawn ``tx_origin``)
  are in the key, so tenants whose lane 0 differs there build engines of
  their own, and a hit rebinds the other lanes' entries;
* the **EngineParams** (caps, ring width, policies) — a frozen dataclass,
  hashable as-is;
* the **lane count** E (the state folds E lanes onto the host axis);
* the **device** (``"cuda:0"``, ``"cpu"``: an engine's tables live there).

A hit REBINDS the new batch's per-job variants (seed keys, loss
thresholds, fault tables) into the cached engine (``FleetEngine.rebind``)
and runs it. The port traces and compiles nothing, so what a hit saves is
the engine's construction: the contract is "a hit builds no engine" — the
same ``FleetEngine`` object, no ``FleetEngine.__init__``, no kernel
rebuild (``tests/test_torch_serve.py``). A rebind refused by the engine's
structure (fault table shapes / gates changed) falls back to a fresh build
and counts as a miss.

Capacity is a small LRU (a cached engine holds its ctx tables on the
device; an unbounded cache would pin device memory across tenants).
Hit/miss/evict counters feed the daemon's Prometheus ledger (SERVE_SPECS).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np

from shadow1_tpu_torch.fleet.expand import _VARIABLE_EXP, FleetConfigError


def _fold(h, x) -> None:
    """Feed one config value into the fingerprint hash."""
    if isinstance(x, np.ndarray):
        h.update(f"nd{x.shape}{x.dtype}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, dict):
        for k in sorted(x):
            h.update(str(k).encode())
            _fold(h, x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            _fold(h, v)
    else:
        h.update(repr(x).encode())


def shape_class_key(exp, params, n_exp: int, device: str = "cpu") -> tuple:
    """The engine-cache key for a batch of ``n_exp`` lanes of ``exp``'s
    shape class under ``params`` on ``device``. Two batches with equal
    keys differ at most in the fleet-variable knobs (seed / loss / faults
    / stop_time / per-lane max_rounds), which a rebind swaps in."""
    h = hashlib.sha256()
    for f in dataclasses.fields(type(exp)):
        if f.name in _VARIABLE_EXP:
            continue
        h.update(f.name.encode())
        _fold(h, getattr(exp, f.name))
    return (h.hexdigest(), params, int(n_exp), str(device))


class EngineCache:
    """LRU cache of built FleetEngines with hit/miss/evict counters."""

    def __init__(self, capacity: int = 4):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict[tuple, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def counters(self) -> dict[str, int]:
        return {"cache_hits": self.hits, "cache_misses": self.misses,
                "cache_evictions": self.evictions,
                "cache_entries": len(self._entries)}

    def get(self, exps: list, params, max_rounds=None, device="cpu"):
        """(engine, "hit"|"miss") for a batch of experiments on ``device``.

        On a hit the cached engine is rebound to the new experiment set (no
        engine is built); a rebind the engine refuses rebuilds and
        REPLACES the entry (counted as a miss — the old engine could not
        serve this batch, so keeping it would pin its device tables)."""
        from shadow1_tpu_torch.fleet.engine import FleetEngine

        key = shape_class_key(exps[0], params, len(exps), device)
        eng = self._entries.get(key)
        if eng is not None:
            try:
                eng.rebind(exps, max_rounds)
            except FleetConfigError:
                del self._entries[key]
            else:
                self._entries.move_to_end(key)
                self.hits += 1
                return eng, "hit"
        eng = FleetEngine(exps, params, max_rounds, device=device)
        self._entries[key] = eng
        self._entries.move_to_end(key)
        self.misses += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return eng, "miss"

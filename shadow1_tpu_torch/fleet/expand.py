"""Sweep expansion — the ``sweep:`` YAML section → per-experiment tables.

A copy of the JAX package's ``fleet/expand.py`` (which imports no JAX; the
port keeps its own copy, as it imports nothing of that package), widened
by the apps' per-lane ``model_cfg`` entries (``lane_cfg_keys``). Fleet
mode (``fleet/``) answers a whole parameter sweep as ONE device program:
E experiment variants share the window loop (``fleet/engine.py``). This
module is the config half: it expands a base experiment document plus a
``sweep:`` section into E concrete :class:`CompiledExperiment` artifacts
and validates the *fleet contract* (docs/SEMANTICS.md §"Fleet contract"):

* **may vary per experiment** — ``general.seed`` (per-experiment RNG
  streams), path loss probabilities (``network.single_vertex.loss`` /
  anything that changes only ``loss_vv``), the whole ``faults:`` section
  (host churn / link outages / loss ramps — tables pad to a common shape
  with inert entries), the legacy per-group ``stop_time`` churn,
  ``engine.max_rounds`` (a traced scalar in the round loop), and the
  ``model_cfg`` entries the app declares per lane (its ``LANE_CFG``:
  Bitcoin's seed-drawn ``tx_origin``), at equal shape and dtype;
* **must be shape-uniform** — host count, topology latencies (the
  conservative window derives from them), ``stop_time`` horizon
  (``general.stop_time``), every capacity knob and every other
  ``engine:`` field: these pick tensor shapes or trace-time structure, so
  a variant that changes them cannot ride the same compiled program.
  Violations raise :class:`FleetConfigError` with ``kind="shape"`` and a
  message naming the knob.

Schema::

    sweep:
      count: 16            # E experiments; seeds default base_seed + i
      base_seed: 1         # default: the base doc's general.seed
      seeds: [1, 2, 3]     # explicit per-experiment general.seed list
      vary:                # per-experiment override documents, deep-merged
        - {}               #   onto the base doc (general/network/faults/
        - {network: {single_vertex: {loss: 0.02}}}   # engine.max_rounds)
        - {faults: {hosts: [{group: h, down_at: 1 s, up_at: 2 s}]}}

``count``/``seeds``/``vary`` may appear together; every one present must
agree on E. Unknown ``sweep:`` keys are rejected like every other config
section (the PR 5 ``_reject_unknown`` pattern); typos *inside* a ``vary``
entry fail in ``build_experiment``'s own section validation, since each
merged document is compiled through the one standard path.

``yaml`` is imported only by ``load_sweep``, and only for YAML text: the
card's machine builds its sweeps in code
(``config/compiled.sweep_phold_experiments``) or reads them as JSON.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from shadow1_tpu_torch.config.experiment import _reject_unknown, build_experiment
from shadow1_tpu_torch.consts import EngineParams


class FleetConfigError(ValueError):
    """A sweep/fleet configuration the batched-experiment plane cannot run.

    ``kind`` classifies the rejection:

    * ``"schema"`` — malformed ``sweep:`` section (unknown keys, length
      mismatches);
    * ``"shape"``  — a swept knob would change plane shapes or trace-time
      structure mid-fleet (differing host counts, latencies, caps, ...);
    * ``"uniform"`` — a swept knob is not in the fleet-variable set but
      differs between experiments;
    * ``"mode"``   — a runtime mode the fleet plane rejects by contract
      (the sharded engine).

    ``knob`` names the offending field when one is identifiable.
    """

    def __init__(self, msg: str, kind: str = "schema", knob: str | None = None):
        super().__init__(msg)
        self.kind = kind
        self.knob = knob


_SWEEP_KEYS = ("count", "base_seed", "seeds", "vary")


def _deep_merge(base, over):
    """Recursive dict merge: ``over`` wins; non-dict values replace."""
    if isinstance(base, dict) and isinstance(over, dict):
        out = dict(base)
        for k, v in over.items():
            out[k] = _deep_merge(base.get(k), v) if k in base else v
        return out
    return over


def expand_sweep_docs(doc: dict) -> list[dict]:
    """Base document (with a ``sweep:`` section) → E per-experiment docs.

    Pure dict surgery — each returned doc is a standalone experiment file
    (no ``sweep:`` key) that compiles through ``build_experiment``
    unchanged; experiment i is the base with ``seeds[i]`` and ``vary[i]``
    applied. Raises FleetConfigError on schema problems."""
    sweep = doc.get("sweep")
    if not isinstance(sweep, dict):
        raise FleetConfigError(
            "fleet mode needs a `sweep:` section in the config "
            "(see docs/SEMANTICS.md §'Fleet contract')")
    try:
        _reject_unknown("sweep:", sweep, _SWEEP_KEYS)
    except AssertionError as e:
        raise FleetConfigError(str(e)) from None
    seeds = sweep.get("seeds")
    vary = sweep.get("vary")
    count = sweep.get("count")
    # Type hardening BEFORE any len()/int(): a malformed sweep must fail
    # as a structured FleetConfigError (the CLI's fleet_config record),
    # never a raw TypeError traceback.
    if seeds is not None and not isinstance(seeds, (list, tuple)):
        raise FleetConfigError(
            f"sweep.seeds must be a list, got {type(seeds).__name__}")
    if vary is not None and not isinstance(vary, (list, tuple)):
        raise FleetConfigError(
            f"sweep.vary must be a list of override mappings, got "
            f"{type(vary).__name__}")
    sizes = {}
    if seeds is not None:
        sizes["seeds"] = len(seeds)
    if vary is not None:
        sizes["vary"] = len(vary)
    if count is not None:
        try:
            sizes["count"] = int(count)
        except (TypeError, ValueError):
            raise FleetConfigError(
                f"sweep.count must be an integer, got {count!r}") from None
    if not sizes:
        raise FleetConfigError(
            "sweep: needs at least one of count / seeds / vary")
    if len(set(sizes.values())) > 1:
        raise FleetConfigError(
            f"sweep: count/seeds/vary disagree on the experiment count: "
            f"{sizes}")
    n = next(iter(sizes.values()))
    if n < 1:
        raise FleetConfigError(f"sweep: needs >= 1 experiment, got {n}")
    base = {k: v for k, v in doc.items() if k != "sweep"}
    if seeds is None:
        base_seed = int(sweep.get(
            "base_seed", base.get("general", {}).get("seed", 1)))
        seeds = [base_seed + i for i in range(n)]
    docs = []
    for i in range(n):
        d = copy.deepcopy(base)
        over = vary[i] if vary is not None else None
        if over is not None and not isinstance(over, dict):
            raise FleetConfigError(
                f"sweep.vary[{i}] must be a mapping, got "
                f"{type(over).__name__}")
        over = over or {}  # a YAML `- ~` / bare `-` entry means "no override"
        if over:
            d = _deep_merge(d, copy.deepcopy(over))
        gen = dict(d.get("general", {}))
        # Explicit vary[i].general.seed wins over the seeds list.
        if "seed" not in (over.get("general") or {}):
            try:
                gen["seed"] = int(seeds[i])
            except (TypeError, ValueError):
                raise FleetConfigError(
                    f"sweep.seeds[{i}] must be an integer, got "
                    f"{seeds[i]!r}") from None
        d["general"] = gen
        docs.append(d)
    return docs


@dataclasses.dataclass
class FleetPlan:
    """E compiled experiments sharing one shape class, ready for the
    batched engine. ``params`` is the fleet-uniform EngineParams (with
    experiment 0's max_rounds); ``max_rounds`` is the per-experiment list
    (the one engine knob the fleet contract lets vary)."""

    exps: list                 # list[CompiledExperiment], len E
    params: EngineParams
    max_rounds: list[int]
    scheduler: str
    labels: list[dict]         # per-experiment identity for records

    @property
    def n_exp(self) -> int:
        return len(self.exps)

    def subset(self, exp_ids) -> "FleetPlan":
        """The sub-fleet plan holding only the sweep-global experiment
        ids ``exp_ids``, in that order — what a resume builds when a
        lineage generation's ``lanes`` meta says the sweep had already
        quarantined/finalized lanes (cli._fleet_main; ids absent from
        the plan are ignored so a stale manifest cannot crash the
        resume)."""
        by_gid = {l["exp"]: i for i, l in enumerate(self.labels)}
        keep = [by_gid[g] for g in exp_ids if g in by_gid]
        return FleetPlan(
            exps=[self.exps[i] for i in keep],
            params=self.params,
            max_rounds=[self.max_rounds[i] for i in keep],
            scheduler=self.scheduler,
            labels=[self.labels[i] for i in keep],
        )


# EngineParams fields allowed to differ between fleet experiments. Every
# other field is shape-affecting or trace-structural (caps pick tensor
# shapes; impls/policies pick traced code paths) and must be uniform.
_VARIABLE_PARAMS = ("max_rounds",)

# CompiledExperiment fields allowed to differ (the fleet-variable set);
# everything else must compare equal. ``stop_time`` is legacy churn and
# compiles into the same per-experiment fault tables as ``faults``. Within
# ``model_cfg``, which is otherwise pinned, the keys the app names in its
# ``LANE_CFG`` (``lane_cfg_keys``) may differ too, at equal shape and
# dtype: the fleet binds them per lane as ``[E, ...]`` arrays
# (``fleet/engine.fleet_model_cfg``).
_VARIABLE_EXP = ("seed", "loss_vv", "faults", "stop_time", "dns")

# Fields whose divergence means a different SHAPE CLASS (the error must say
# so: these change tensor shapes or the conservative window, not just
# values).
_SHAPE_EXP = ("n_hosts", "lat_vv", "jitter_vv", "host_vertex", "end_time")


def lane_cfg_keys(exp) -> tuple[str, ...]:
    """The ``model_cfg`` keys whose values may differ between the lanes of
    a fleet of ``exp``: its app's ``LANE_CFG`` (none for other models)."""
    app = exp.model_cfg.get("app") if exp.model == "net" else None
    if app is None:
        return ()
    from shadow1_tpu_torch.net import _app_module

    return tuple(getattr(_app_module(app), "LANE_CFG", ()))


def _model_cfg_uniform(a: dict, b: dict, lane_keys) -> bool:
    """Whether two experiments' ``model_cfg`` may share a fleet: equal but
    in ``lane_keys``, whose values need only equal shape and dtype."""
    if set(a) != set(b):
        return False
    for k in a:
        if k in lane_keys:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if x.shape != y.shape or x.dtype != y.dtype:
                return False
        elif not _np_equal(a[k], b[k]):
            return False
    return True


def _np_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).shape == np.asarray(b).shape
                and np.array_equal(np.asarray(a), np.asarray(b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_np_equal(a[k], b[k]) for k in a)
    return a == b


def check_uniform(exps: list, params_list: list[EngineParams],
                  schedulers: list[str] | None = None
                  ) -> tuple[EngineParams, list[int]]:
    """Enforce the fleet contract across compiled experiments.

    Returns (uniform EngineParams, per-experiment max_rounds list); raises
    FleetConfigError naming the first offending knob."""
    base = exps[0]
    lane_keys = lane_cfg_keys(base)
    if schedulers and len(set(schedulers)) > 1:
        raise FleetConfigError(
            f"sweep varies engine.scheduler ({sorted(set(schedulers))}) — "
            f"the whole fleet runs one engine", kind="shape",
            knob="scheduler")
    for i, exp in enumerate(exps[1:], start=1):
        for f in _SHAPE_EXP:
            if not _np_equal(getattr(base, f), getattr(exp, f)):
                raise FleetConfigError(
                    f"sweep experiment {i} changes {f!r} — that changes "
                    f"plane shapes (or the conservative window) mid-fleet; "
                    f"fleet experiments must share one topology shape "
                    f"class (docs/SEMANTICS.md §'Fleet contract')",
                    kind="shape", knob=f)
        for f in (fld.name for fld in dataclasses.fields(type(base))):
            if f in _VARIABLE_EXP or f in _SHAPE_EXP:
                continue
            if f == "model_cfg" and _model_cfg_uniform(
                    base.model_cfg, exp.model_cfg, lane_keys):
                continue
            if not _np_equal(getattr(base, f), getattr(exp, f)):
                raise FleetConfigError(
                    f"sweep experiment {i} varies {f!r}, which is outside "
                    f"the fleet-variable set (seed / loss / faults / "
                    f"stop_time / engine.max_rounds)", kind="uniform",
                    knob=f)
    p0 = params_list[0]
    for i, p in enumerate(params_list[1:], start=1):
        for f in (fld.name for fld in dataclasses.fields(EngineParams)):
            if f in _VARIABLE_PARAMS:
                continue
            if getattr(p0, f) != getattr(p, f):
                raise FleetConfigError(
                    f"sweep experiment {i} changes engine.{f} — engine "
                    f"capacities and implementation knobs are shape- or "
                    f"trace-structural and must be fleet-uniform (only "
                    f"engine.max_rounds may vary)", kind="shape",
                    knob=f"engine.{f}")
    return p0, [int(p.max_rounds) for p in params_list]


def expand_sweep(doc: dict, base_dir: str = ".") -> FleetPlan:
    """Base document with ``sweep:`` → validated FleetPlan."""
    docs = expand_sweep_docs(doc)
    exps, params_list, scheds = [], [], []
    for d in docs:
        exp, params, scheduler = build_experiment(d, base_dir=base_dir)
        exps.append(exp)
        params_list.append(params)
        scheds.append(scheduler)
    params, max_rounds = check_uniform(exps, params_list, scheds)
    labels = [{"exp": i, "seed": int(e.seed)} for i, e in enumerate(exps)]
    return FleetPlan(exps=exps, params=params, max_rounds=max_rounds,
                     scheduler=scheds[0], labels=labels)


def load_sweep(path: str) -> FleetPlan:
    """Load a YAML or JSON experiment file with a ``sweep:`` section →
    FleetPlan (``config.experiment.parse_config``)."""
    import os

    from shadow1_tpu_torch.config.experiment import parse_config

    with open(path) as f:
        doc = parse_config(f.read())
    return expand_sweep(doc, base_dir=os.path.dirname(os.path.abspath(path)))

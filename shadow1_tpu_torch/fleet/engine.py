"""FleetEngine — E experiment variants as one device program (port of
``fleet/engine.py``).

The reference stacks E experiments of one shape class on a leading
``[E, ...]`` axis and runs ``jax.vmap`` of the solo window step. The port
folds the lanes into the host axis instead (``core/lanes.py``): a fleet
state keeps the solo layout with E·H host columns, column ``e·H + h``
being host h of lane e, so every plane is ``[C, E·H]`` and the three CUDA
kernels run unchanged at that width, one launch each per round for the
whole fleet. The ctx separates width from population as compaction does
(``n_hosts`` = E·H; ``n_total`` = H and ``hosts`` = ``arange(H)`` tiled E
times are what the models see), and holds the per-lane constants: each
column's RNG key, the ``[E, V, V]`` loss thresholds, the fault tables
(host intervals folded onto the host axis, link and ramp tables ``[E,
L]``, every lane padded with inert entries) and, when they differ, the
lanes' ``max_rounds``.

**Per-experiment determinism contract** (docs/SEMANTICS.md "Fleet
contract"): lane e's digest words, metrics, model summaries and state
leaves are bit-identical to a solo run of experiment e. Draws are keyed
by (lane key, local host, counter), so lanes cannot interact; packets
route to their own lane's columns; every reduction that has no host axis
in a solo run is taken per lane; and a round leaves a lane that pops
nothing as it was, so the round loop runs while some lane is active and
counts ``rounds`` per lane (``core/engine._run_rounds_lanes``).

The telemetry planes are per lane: the ring ``[E, W, F]``, the probe
ring ``[E, W, K, F]`` (every probe watched in every lane) and the link
accumulator ``[E, V, V, F]``; ``drain_rings`` tags each record with its
lane's sweep-global id (``exp``). ``compact_cap`` is dropped with a
warning, as the reference does (bit-identical by the compaction
contract); ``pop_impl`` / ``push_impl`` are parsed and ignored, as in the
solo engine.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any

import numpy as np
import torch

from shadow1_tpu_torch import rng
from shadow1_tpu_torch.config.compiled import NO_STOP
from shadow1_tpu_torch.consts import K_NONE, EngineParams
from shadow1_tpu_torch.core.engine import (
    Engine,
    SimState,
    _model_module,
    build_base_ctx,
    check_digest_params,
    check_probe_params,
    check_supported,
    resolve_device,
)
from shadow1_tpu_torch.core.events import evbuf_init
from shadow1_tpu_torch.fleet.expand import FleetConfigError, check_uniform

# Ctx fields that hold one value per host column: tiled E times.
_TILED = ("hosts", "host_vertex", "bw_up", "bw_dn", "cpu_cost", "tx_qlen_ns",
          "rx_qlen_ns", "aqm_min_ns", "aqm_span_ns", "aqm_pmax_thr")


def _stack_host_intervals(exps) -> tuple[np.ndarray, np.ndarray]:
    """Per-experiment [K_i, H] down/up interval tables → [Kmax, E·H],
    each lane padded with the empty [NO_STOP, NO_STOP) interval no time
    satisfies, then folded onto the host axis."""
    from shadow1_tpu_torch.fault.schedule import host_interval_tensors

    tabs = [host_interval_tensors(e) for e in exps]
    h = exps[0].n_hosts
    kmax = max(max((d.shape[0] for d, _ in tabs), default=0), 1)
    downs, ups = [], []
    for d, u in tabs:
        pad = np.full((kmax - d.shape[0], h), NO_STOP, np.int64)
        downs.append(np.concatenate([d.reshape(-1, h), pad]))
        ups.append(np.concatenate([u.reshape(-1, h), pad]))
    return np.concatenate(downs, axis=1), np.concatenate(ups, axis=1)


def _stack_tables(tabs):
    """[E, Lmax] tables from per-experiment [L_i] column tuples (None for
    an experiment without any), or None when no experiment has any.
    Padding rows are all 0, so t0 == t1: an empty window no time hits."""
    if all(t is None for t in tabs):
        return None
    ref = next(t for t in tabs if t is not None)
    lmax = max(len(t[0]) for t in tabs if t is not None)

    def pad(t):
        if t is None:
            t = tuple(np.zeros(0, np.asarray(a).dtype) for a in ref)
        n = lmax - len(t[0])
        return tuple(np.concatenate([np.asarray(a), np.zeros(n, np.asarray(a).dtype)])
                     for a in t)

    cols = [pad(t) for t in tabs]
    return tuple(np.stack([c[i] for c in cols]) for i in range(len(ref)))


def fleet_model_cfg(cfg: dict, n_hosts: int, n_exp: int) -> dict:
    """The model config a fleet's init reads: every array whose first axis
    is the host axis (the apps' per-host config, read only at init)
    tiled E times along it; scalars and other arrays as they are."""
    out = {}
    for k, v in cfg.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n_hosts:
            v = np.concatenate([v] * n_exp, axis=0)
        out[k] = v
    return out


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)


def _is_host(x, width: int) -> bool:
    return isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[-1] == width


def slice_experiment(st: SimState, e: int, n_exp: int) -> SimState:
    """Lane e of a fleet state as a standalone solo SimState: its host
    columns of every host-axis leaf, its entry of every per-lane leaf
    (metrics, ring rows). Fresh contiguous tensors: a solo ``Engine`` of
    the same experiment continues it bit-identically."""
    return select_lanes(st, [e], n_exp, solo=True)


def select_lanes(st: SimState, keep, n_exp: int, solo: bool = False) -> SimState:
    """The sub-fleet state holding only lanes ``keep`` (local indices, in
    order): the quarantine and finalize repack. Lanes never read one
    another's columns, so a kept lane continues bit-identically. With
    ``solo`` (one lane) the lane axis is dropped: a solo state."""
    from shadow1_tpu_torch.core.compact import _tree_map

    keep = [int(k) for k in keep]
    width = st.evbuf.kind.shape[-1]
    h = width // n_exp
    dev = st.evbuf.kind.device
    cols = torch.cat([torch.arange(k * h, (k + 1) * h, device=dev)
                      for k in keep])
    idx = torch.tensor(keep, device=dev)

    def host(x):
        return x.index_select(-1, cols).contiguous()

    def lane(x):
        y = x.index_select(0, idx)
        return (y[0] if solo else y).contiguous()

    out = st._replace(
        evbuf=_tree_map(lambda x: host(x) if _is_host(x, width) else x.clone(),
                        st.evbuf),
        outbox=_tree_map(host, st.outbox),
        model=_tree_map(lambda x: host(x) if _is_host(x, width) else x.clone(),
                        st.model),
        metrics=_tree_map(lane, st.metrics),
        cpu_busy=host(st.cpu_busy),
        win_start=st.win_start.clone(),
        telem=None if st.telem is None else st.telem._replace(
            buf=lane(st.telem.buf)),
        probes=None if st.probes is None else st.probes._replace(
            buf=lane(st.probes.buf)),
        links=None if st.links is None else st.links._replace(
            buf=lane(st.links.buf)),
    )
    return out


class FleetEngine(Engine):
    """Batched engine over E CompiledExperiments of one shape class.

    The solo ``Engine``'s API (``init_state``, ``run``, ``at_caps``,
    ``n_windows``, ``window``, ``params``, ``ctx``) plus the per-experiment
    accessors of the reference (``metrics_per_exp``, ``model_summary(st,
    e)``, ``drain_rings``, ``lane_done``, ``slice_experiment``,
    ``select_lanes``, ``rebind``, ``variant_signature``).
    ``metrics_dict`` is the FLEET AGGREGATE (counters summed, gauges
    maxed) so generic chunk plumbing keeps working; the per-experiment
    truth is ``metrics_per_exp``."""

    def __init__(self, exps: list, params: EngineParams | None = None,
                 max_rounds: list[int] | None = None, device=None):
        if not exps:
            raise FleetConfigError("fleet needs >= 1 experiment")
        for exp in exps:
            exp.validate()
        params = params or EngineParams()
        check_uniform(exps, [params] * len(exps))
        check_digest_params(params)
        check_probe_params(params)
        from shadow1_tpu_torch.telemetry.links import check_link_params

        check_link_params(params, np.asarray(exps[0].lat_vv).shape[0])
        check_supported(exps[0], params)
        params = self._resolve_fleet_params(params)
        self.exps = list(exps)
        self.exp = exps[0]
        self.n_exp = len(exps)
        self.device = resolve_device(device)
        self.window = self.exp.window
        self.n_windows = int(math.ceil(self.exp.end_time / self.window))
        self.max_rounds = [int(m) for m in
                           (max_rounds or [params.max_rounds] * self.n_exp)]
        if len(self.max_rounds) != self.n_exp:
            raise FleetConfigError(
                f"max_rounds list ({len(self.max_rounds)}) != experiment "
                f"count ({self.n_exp})")
        if (len(set(self.max_rounds)) == 1
                and self.max_rounds[0] != params.max_rounds):
            params = dataclasses.replace(params, max_rounds=self.max_rounds[0])
        self.params = params
        # Sweep-global id of lane 0 (a sub-batch) and the explicit
        # per-lane ids after a quarantine or finalize repack (fleet/run.py).
        self.exp_base = 0
        self.exp_ids: list[int] | None = None
        self._model = _model_module(self.exp.model)
        self._bind()

    # -- construction ------------------------------------------------------
    @staticmethod
    def _resolve_fleet_params(params: EngineParams) -> EngineParams:
        if params.compact_cap:
            warnings.warn("fleet mode ignores compact_cap: the fleet runs "
                          "full-width (bit-identical by the compaction "
                          "contract)")
            params = dataclasses.replace(params, compact_cap=0)
        return params

    def _build_ctx(self):
        exps, e_n, dev = self.exps, self.n_exp, self.device
        h = self.exp.n_hosts
        base = build_base_ctx(self.exp, self.params, dev, window=self.window)
        repl = {f: getattr(base, f).repeat(e_n) for f in _TILED
                if getattr(base, f) is not None}
        keys = torch.tensor([rng.base_key(e.seed) for e in exps],
                            dtype=torch.int64, device=dev)
        thr = np.stack([rng.prob_threshold(np.asarray(e.loss_vv, np.float32))
                        for e in exps]).astype(np.int64)
        down, up = _stack_host_intervals(exps)
        from shadow1_tpu_torch.fault.schedule import link_tables, ramp_tables
        from shadow1_tpu_torch.telemetry.probes import fleet_probe_index

        lf = _stack_tables([link_tables(e) for e in exps])
        rt = _stack_tables([ramp_tables(e) for e in exps])
        nonuniform = len(set(self.max_rounds)) > 1
        app_tables = None
        if self.exp.model == "net":
            from shadow1_tpu_torch.net import _app_module

            app = _app_module(self.exp.model_cfg["app"])
            if hasattr(app, "tables"):
                app_tables = app.tables(self.exp.model_cfg, dev)
        return dataclasses.replace(
            base, **repl,
            model_cfg=fleet_model_cfg(self.exp.model_cfg, h, e_n),
            app_tables=app_tables,
            n_hosts=e_n * h, n_total=h, n_exp=e_n,
            lane=torch.arange(e_n, device=dev).repeat_interleave(h),
            key=keys.repeat_interleave(h),
            loss_thr_vv=_i64(thr, dev),
            fault_down=_i64(down, dev), fault_up=_i64(up, dev),
            link_fault=None if lf is None else tuple(_i64(a, dev) for a in lf),
            loss_ramp=None if rt is None else tuple(_i64(a, dev) for a in rt),
            has_stop=bool(down.min() < NO_STOP),
            has_restart=bool((up < NO_STOP).any()),
            has_link_fault=lf is not None, has_loss_ramp=rt is not None,
            lane_max_rounds=tuple(self.max_rounds) if nonuniform else None,
            probe_index=(fleet_probe_index(self.params.probes, h, e_n, dev)
                         if self.params.probes else None),
        )

    def _bind(self):
        """Build the fleet ctx for ``self.exps`` and, when some host
        restarts, the restart capture: the model state as init builds it
        under each lane's constants (the fleet's init is every lane's)."""
        self.ctx = self._build_ctx()
        if self.ctx.has_restart:
            model0, _, _ = self._model.init(
                self.ctx, evbuf_init(self.ctx.n_hosts, self.params.ev_cap,
                                     self.device))
            self.ctx = dataclasses.replace(self.ctx, init_model=model0)
        self._handlers = self._model.make_handlers(self.ctx)
        self._pre_window = getattr(self._model, "make_pre_window",
                                   lambda c: None)(self.ctx)

    def variant_signature(self) -> tuple:
        """What a ``rebind`` must keep: lane count, the fault gates and the
        fault tables' shapes, and whether ``max_rounds`` varies."""
        c = self.ctx

        def shape(t):
            return None if t is None else tuple(tuple(a.shape) for a in t)

        return (self.n_exp, c.has_stop, c.has_restart, c.has_link_fault,
                c.has_loss_ramp, tuple(c.fault_down.shape), shape(c.link_fault),
                shape(c.loss_ramp), c.lane_max_rounds is not None)

    def rebind(self, exps: list, max_rounds: list[int] | None = None
               ) -> "FleetEngine":
        """Swap a NEW experiment set of the same shape class into this
        engine: the fleet-variable knobs (seed, loss, fault schedules,
        legacy stop_time, per-lane max_rounds) may differ, everything else
        must equal the bound set's. Raises ``FleetConfigError`` as the
        reference does when the new set would change the program's
        structure (lane count, fault gates, table shapes)."""
        if len(exps) != self.n_exp:
            raise FleetConfigError(
                f"rebind: lane count {len(exps)} != compiled {self.n_exp} "
                f"(state shapes differ — build a fresh engine)",
                kind="mode", knob="n_exp")
        for exp in exps:
            exp.validate()
        check_uniform(exps, [self.params] * len(exps))
        from shadow1_tpu_torch.fleet.expand import _VARIABLE_EXP, _np_equal

        for f in (fld.name for fld in dataclasses.fields(type(self.exp))):
            if f in _VARIABLE_EXP:
                continue
            if not _np_equal(getattr(self.exp, f), getattr(exps[0], f)):
                raise FleetConfigError(
                    f"rebind: {f!r} differs from the bound engine's — a "
                    f"different shape class needs a fresh engine",
                    kind="shape", knob=f)
        new_mr = [int(m) for m in
                  (max_rounds or [self.params.max_rounds] * self.n_exp)]
        if len(set(new_mr)) == 1 and new_mr[0] != self.params.max_rounds:
            raise FleetConfigError(
                f"rebind: uniform max_rounds {new_mr[0]} != bound "
                f"{self.params.max_rounds}; build a fresh engine",
                kind="mode", knob="max_rounds")
        old = (self.exps, self.exp, self.max_rounds, self.ctx,
               self._handlers, self._pre_window)
        sig = self.variant_signature()
        self.exps, self.exp, self.max_rounds = list(exps), exps[0], new_mr
        try:
            self._bind()
            if self.variant_signature() != sig:
                raise FleetConfigError(
                    "rebind: the fault gates or table shapes changed — "
                    "build a fresh engine", kind="mode", knob="variants")
        except Exception:
            (self.exps, self.exp, self.max_rounds, self.ctx, self._handlers,
             self._pre_window) = old
            raise
        self.exp_base = 0
        self.exp_ids = None
        return self

    # -- accessors ---------------------------------------------------------
    def slice_experiment(self, st: SimState, e: int) -> SimState:
        return slice_experiment(st, e, self.n_exp)

    def select_lanes(self, st: SimState, keep) -> SimState:
        return select_lanes(st, keep, self.n_exp)

    @staticmethod
    def metrics_per_exp(st: SimState) -> list[dict[str, int]]:
        """Per-experiment metric dicts (one device→host copy)."""
        names = st.metrics._fields
        arr = torch.stack(list(st.metrics)).cpu().numpy()   # [F, E]
        return [{k: int(arr[i, e]) for i, k in enumerate(names)}
                for e in range(arr.shape[1])]

    @staticmethod
    def metrics_dict(st: SimState) -> dict[str, int]:
        """Fleet AGGREGATE: counters sum across experiments, gauges max;
        the lanes run their windows and rounds in step, so ``windows`` and
        ``rounds`` report the max."""
        from shadow1_tpu_torch.telemetry.registry import gauge_names

        gauges = set(gauge_names())
        arr = torch.stack(list(st.metrics)).cpu().numpy()
        out = {}
        for i, k in enumerate(st.metrics._fields):
            out[k] = int(arr[i].max()) if k in gauges else int(arr[i].sum())
        out["windows"] = int(arr[st.metrics._fields.index("windows")].max())
        out["rounds"] = int(arr[st.metrics._fields.index("rounds")].max())
        return out

    def drain_rings(self, st: SimState, start: int = 0) -> list[dict]:
        """Per-experiment drains of the ring, the probe ring and the link
        accumulator: the solo drains per lane, each record tagged with its
        sweep-global experiment id (``exp``), ring records first, then
        ``flow``, then ``link`` (the reference's order). One device→host
        copy per plane and one of the window counters, then numpy views."""
        from types import SimpleNamespace

        from shadow1_tpu_torch.telemetry.links import drain_links
        from shadow1_tpu_torch.telemetry.probes import drain_probes
        from shadow1_tpu_torch.telemetry.ring import drain_ring

        windows = st.metrics.windows.cpu().numpy()
        recs: list[dict] = []
        planes = (("telem", lambda s: drain_ring(s, self.window, start=start)),
                  ("probes", lambda s: drain_probes(
                      s, self.window, self.params.probes, start=start)),
                  ("links", lambda s: drain_links(s, self.window,
                                                  start=start)))
        for name, drain in planes:
            plane = getattr(st, name)
            if plane is None:
                continue
            buf = plane.buf.cpu()
            for e in range(buf.shape[0]):
                lane = SimpleNamespace(
                    **{name: SimpleNamespace(buf=buf[e])},
                    metrics=SimpleNamespace(windows=int(windows[e])))
                gid = (self.exp_ids[e] if self.exp_ids is not None
                       else e + self.exp_base)
                recs += [{**r, "exp": int(gid)} for r in drain(lane)]
        return recs

    def lane_done(self, st: SimState) -> np.ndarray:
        """Per-lane "nothing can ever happen again" flags ([E] bool): the
        lane's event buffer holds no live event (see the reference)."""
        live = (st.evbuf.kind != K_NONE).any(dim=0)
        return ~live.view(self.n_exp, -1).any(dim=1).cpu().numpy()

    def model_summary(self, st: SimState, e: int = 0) -> dict[str, Any]:
        lane = slice_experiment(st, e, self.n_exp)
        solo_ctx = dataclasses.replace(
            self.ctx, n_hosts=self.exp.n_hosts, n_exp=0, lane=None)
        return {k: v.cpu().numpy()
                for k, v in self._model.summary(lane.model, solo_ctx).items()}

"""Compiled experiment artifact — the common input to both engines.

The reference parses an XML experiment file plus a GraphML topology at
startup (src/main/core/support/configuration.c, src/main/routing/topology.c)
and builds igraph structures queried lazily. We instead *compile* the
experiment on the host into dense numpy tensors once; both the CPU oracle
engine and the TPU engine consume this identical artifact, which is the
cross-validation seam mandated by BASELINE.json ("CPU and TPU engines are
selected from the same config file").

Topology representation: Tor/Bitcoin experiment graphs have few *network*
vertices (points of presence) with many attached hosts, so we precompute
all-pairs shortest-path latency/loss over vertices (SURVEY §7.1) and keep a
host→vertex attachment vector. lat_vv must be strictly positive everywhere:
its minimum IS the conservative window (the reference computes the same
runahead bound from minimum link latency in src/main/core/master.c).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


NO_STOP = (1 << 62)  # "host never stops" sentinel (i64-safe)


@dataclasses.dataclass
class CompiledExperiment:
    n_hosts: int
    seed: int
    end_time: int                 # ns
    lat_vv: np.ndarray            # i64 [V,V] path latency ns, all > 0
    loss_vv: np.ndarray           # f32 [V,V] end-to-end path loss prob
    host_vertex: np.ndarray       # i32 [H] vertex each host attaches to
    bw_up: np.ndarray             # i64 [H] uplink bits/s
    bw_dn: np.ndarray             # i64 [H] downlink bits/s
    model: str = "phold"          # workload model name
    model_cfg: dict[str, Any] = dataclasses.field(default_factory=dict)
    # --- fidelity knobs (reference: router.c queues, config churn, edge
    # jitter, host/cpu.c), all defaulted off ---
    jitter_vv: np.ndarray | None = None   # i64 [V,V] max ± jitter ns per pkt
    stop_time: np.ndarray | None = None   # i64 [H] host halts at this time
    cpu_ns_per_event: np.ndarray | None = None  # i64 [H] virtual CPU cost
    tx_qlen_bytes: np.ndarray | None = None     # i64 [H] NIC up-queue, 0=inf
    rx_qlen_bytes: np.ndarray | None = None     # i64 [H] NIC down-queue, 0=inf
    # RED AQM on the uplink queue (router.c's upstream active queue
    # management, behind a per-group flag): early-drop probability ramps
    # linearly 0→pmax as the instantaneous backlog crosses [min, max) bytes,
    # certain drop at ≥ max. aqm_max_bytes == 0 disables (the default).
    aqm_min_bytes: np.ndarray | None = None     # i64 [H]
    aqm_max_bytes: np.ndarray | None = None     # i64 [H], 0 = AQM off
    aqm_pmax: np.ndarray | None = None          # f64 [H] drop prob at max
    # Deterministic fault plane (fault/schedule.FaultSchedule or None):
    # host down/up cycles, link outage windows, timed loss ramps — compiled
    # to dense tables both engines share (docs/SEMANTICS.md §"Fault
    # plane"). The legacy per-group stop_time above is the degenerate
    # one-interval case and merges into the same tables.
    faults: Any = None
    # Host-side name registry (config/dns.py); None for programmatic
    # experiments (ids only). Never enters device state.
    dns: Any = None
    # Topology vertex names in id order (GraphML node ids, or ["v0"] for
    # single_vertex); None for programmatic experiments. Host-side only —
    # link records and the pcapdump --edge filter resolve through it.
    vertex_names: Any = None

    def __post_init__(self):
        h, z = self.n_hosts, np.int64
        if self.jitter_vv is None:
            self.jitter_vv = np.zeros_like(self.lat_vv, z)
        if self.stop_time is None:
            self.stop_time = np.full(h, NO_STOP, z)
        if self.cpu_ns_per_event is None:
            self.cpu_ns_per_event = np.zeros(h, z)
        if self.tx_qlen_bytes is None:
            self.tx_qlen_bytes = np.zeros(h, z)
        if self.rx_qlen_bytes is None:
            self.rx_qlen_bytes = np.zeros(h, z)
        if self.aqm_min_bytes is None:
            self.aqm_min_bytes = np.zeros(h, z)
        if self.aqm_max_bytes is None:
            self.aqm_max_bytes = np.zeros(h, z)
        if self.aqm_pmax is None:
            self.aqm_pmax = np.zeros(h, np.float64)

    @property
    def window(self) -> int:
        """Conservative lookahead = min worst-case path latency (runahead).

        With jitter the bound is min(lat − jitter): the earliest any packet
        can arrive (the reference computes runahead from minimum link
        latency in src/main/core/master.c)."""
        return int((self.lat_vv - self.jitter_vv).min())

    def validate(self) -> None:
        assert self.lat_vv.min() > 0, "zero-latency paths break the conservative window"
        assert self.lat_vv.shape == self.loss_vv.shape == self.jitter_vv.shape
        assert (self.jitter_vv >= 0).all()
        assert (self.lat_vv - self.jitter_vv).min() > 0, (
            "jitter ≥ latency would allow arrivals inside the current window"
        )
        assert self.host_vertex.max() < self.lat_vv.shape[0]
        assert (self.bw_up > 0).all() and (self.bw_dn > 0).all()
        assert (self.stop_time > 0).all()
        assert (self.cpu_ns_per_event >= 0).all()
        assert (self.tx_qlen_bytes >= 0).all() and (self.rx_qlen_bytes >= 0).all()
        on = self.aqm_max_bytes > 0
        assert (self.aqm_min_bytes >= 0).all()
        assert (self.aqm_min_bytes[on] < self.aqm_max_bytes[on]).all(), (
            "RED needs aqm_min_bytes < aqm_max_bytes where enabled"
        )
        assert ((self.aqm_pmax[on] > 0) & (self.aqm_pmax[on] <= 1)).all(), (
            "RED needs 0 < aqm_pmax <= 1 where enabled"
        )
        if self.faults is not None:
            self.faults.validate(self.n_hosts, self.lat_vv.shape[0])
        assert self.end_time > 0
        assert int(self.window) < 2**31 - 1, (
            "conservative window must fit the i32 rebased pop keys "
            "(core/events.py t32): window < 2**31 - 1 ns (~2.1 s; the last "
            "value is the clamp sentinel I32_HORIZON, so an event exactly "
            "window-1 ahead must still rebase exactly). Topologies with "
            "multi-second minimum latency are out of this engine's design "
            "envelope."
        )


def single_vertex_experiment(
    n_hosts: int,
    seed: int,
    end_time: int,
    latency_ns: int,
    loss: float = 0.0,
    bw_bits: int = 10**9,
    model: str = "phold",
    model_cfg: dict | None = None,
    jitter_ns: int = 0,
    **fidelity,
) -> CompiledExperiment:
    """Minimal topology: every host on one vertex, uniform latency/loss.

    Mirrors the reference's minimal example configs (resource/examples/).
    ``fidelity`` passes through stop_time / cpu_ns_per_event / *_qlen_bytes.
    """
    return CompiledExperiment(
        n_hosts=n_hosts,
        seed=seed,
        end_time=end_time,
        lat_vv=np.full((1, 1), latency_ns, np.int64),
        loss_vv=np.full((1, 1), loss, np.float32),
        jitter_vv=np.full((1, 1), jitter_ns, np.int64),
        host_vertex=np.zeros(n_hosts, np.int32),
        bw_up=np.full(n_hosts, bw_bits, np.int64),
        bw_dn=np.full(n_hosts, bw_bits, np.int64),
        model=model,
        model_cfg=model_cfg or {},
        **fidelity,
    )


# The host layout of configs/churn_filexfer.yaml: per group one server
# (20 Mbit both ways, on vertex 0 "pop_west") and 7 clients (10 Mbit, on
# vertex 1 "pop_east"), each client 12 sequential 250,000-byte flows to its
# group's server, client k starting at 10 ms + 30 ms·(k − 1); every path
# 40 ms (configs/topology_2pop.graphml).
_FX_CLIENTS = 7
_FX_SERVER_BW, _FX_CLIENT_BW = 20_000_000, 10_000_000
_FX_FLOW_BYTES, _FX_FLOW_COUNT = 250_000, 12
_FX_START_NS, _FX_INTERVAL_NS = 10_000_000, 30_000_000
_FX_LATENCY_NS = 40_000_000


def tiled_filexfer_experiment(n_groups: int, seed: int, end_time: int, *,
                              loss: float = 0.001) -> CompiledExperiment:
    """The host layout of ``configs/churn_filexfer.yaml`` (its ``faults:``
    left out) tiled ``n_groups`` times, built in code (no YAML, no
    GraphML): host ``8g`` is group g's server, hosts ``8g + 1 .. 8g + 7``
    its clients (see the ``_FX_*`` constants). The one edge between the
    two vertices loses ``loss`` of its packets (0.1 % in the GraphML). The
    per-host app arrays have the dtypes and defaults the YAML loader
    gives."""
    per = 1 + _FX_CLIENTS
    h = n_groups * per
    k = np.arange(h) % per                      # 0: server, 1..7: clients
    server = k == 0
    i64 = np.int64
    bw = np.where(server, _FX_SERVER_BW, _FX_CLIENT_BW).astype(i64)
    return CompiledExperiment(
        n_hosts=h,
        seed=seed,
        end_time=end_time,
        lat_vv=np.full((2, 2), _FX_LATENCY_NS, i64),
        loss_vv=np.array([[0.0, loss], [loss, 0.0]], np.float32),
        host_vertex=np.where(server, 0, 1).astype(np.int32),
        bw_up=bw,
        bw_dn=bw.copy(),
        model="net",
        model_cfg={
            "role": np.where(server, 0, 1).astype(i64),
            "server": np.where(server, 0, np.arange(h) - k).astype(i64),
            "flow_bytes": np.where(server, 0, _FX_FLOW_BYTES).astype(i64),
            "start_time": np.where(
                server, 0,
                _FX_START_NS + (k - 1) * _FX_INTERVAL_NS).astype(i64),
            "flow_count": np.where(server, 0, _FX_FLOW_COUNT).astype(i64),
            "app": "filexfer",
        },
        vertex_names=["pop_west", "pop_east"],
    )


# configs/sweep_phold.yaml's shape class: 64 PHOLD hosts on one 10 ms
# vertex, 2 initial events per host, 20 ms mean delay, 200 ms; its
# variants (none, 2 % loss, 10 % loss, every host down over [50, 100) ms).
SWEEP_PHOLD_SEEDS = (1, 2, 3, 4)
SWEEP_PHOLD_VARIANTS = ("none", "loss2", "loss10", "churn")


def sweep_phold_experiments(capped_max_rounds: int = 2):
    """The fleet golden's sweep, built in code: every seed of
    ``configs/sweep_phold.yaml`` under every one of its variants (16
    lanes, seed-major), then one more lane (seed 1, no variant) held to
    ``capped_max_rounds`` rounds a window, so that it hits its cap while
    the others run on (the one engine knob a sweep may vary). Returns
    (experiments, EngineParams, per-lane max_rounds, labels); lane e of
    the YAML's own 4-lane sweep is lane 5·e here."""
    from shadow1_tpu_torch.consts import MS, EngineParams
    from shadow1_tpu_torch.fault.schedule import FaultSchedule

    n = 64

    def one(seed, variant):
        exp = single_vertex_experiment(
            n_hosts=n, seed=seed, end_time=200 * MS, latency_ns=10 * MS,
            loss={"loss2": 0.02, "loss10": 0.10}.get(variant, 0.0),
            model="phold",
            model_cfg={"mean_delay_ns": 2.0e7, "init_events": 2})
        if variant == "churn":
            exp.faults = FaultSchedule(
                host_id=np.arange(n), host_down=np.full(n, 50 * MS),
                host_up=np.full(n, 100 * MS))
        return exp

    lanes = [(s, v) for s in SWEEP_PHOLD_SEEDS for v in SWEEP_PHOLD_VARIANTS]
    lanes.append((SWEEP_PHOLD_SEEDS[0], "none"))
    params = EngineParams(ev_cap=64, outbox_cap=32)
    max_rounds = [params.max_rounds] * (len(lanes) - 1) + [capped_max_rounds]
    labels = [{"exp": i, "seed": s, "variant": v, "max_rounds": m}
              for i, ((s, v), m) in enumerate(zip(lanes, max_rounds))]
    return [one(s, v) for s, v in lanes], params, max_rounds, labels


def tgen_experiment(n_hosts: int, seed: int, end_time: int, *,
                    latency_ns: int, bw_bits: int, streams: int,
                    mean_bytes: float, mean_think_ns: float, start_time: int,
                    fixed_size: bool = False) -> CompiledExperiment:
    """An all-active tgen mesh on one vertex, built in code: the layout of
    ``configs/rung2_tgen100.yaml`` and ``configs/dense_tgen50k.yaml`` (one
    host group, every host a client and a server), with the per-host app
    arrays in the dtypes the YAML loader gives."""
    cfg = {} if not fixed_size else {"fixed_size": True}
    cfg.update({
        "active": np.ones(n_hosts, np.int64),
        "streams": np.full(n_hosts, streams, np.int64),
        "mean_bytes": np.full(n_hosts, mean_bytes, np.float64),
        "mean_think_ns": np.full(n_hosts, mean_think_ns, np.float64),
        "start_time": np.full(n_hosts, start_time, np.int64),
        "app": "tgen",
    })
    return single_vertex_experiment(
        n_hosts=n_hosts, seed=seed, end_time=end_time, latency_ns=latency_ns,
        bw_bits=bw_bits, model="net", model_cfg=cfg)


# The consensus weights of configs/rung3_tor1k.yaml and
# configs/rung4_tor10k.yaml (guard, middle, exit) and their cell cap.
_TOR_WEIGHTS = (300, 200, 250)
_TOR_CELLS_MAX = 120


def tor_experiment(*, n_guard: int, n_middle: int, n_exit: int,
                   n_dirauth: int, n_client: int, seed: int, end_time: int,
                   latency_ns: int, relay_bw: int, client_bw: int,
                   n_circuits: int, n_streams: int, mean_stream_cells: float,
                   mean_think_ns: float, start_time: int,
                   client_interval: int = 0,
                   ct_cap: int = 64) -> CompiledExperiment:
    """A Tor network on one vertex, built in code: the host groups of
    ``configs/rung3_tor1k.yaml`` and ``configs/rung4_tor10k.yaml`` in
    their order — guards, middles, exits (relays, with the consensus
    weights ``_TOR_WEIGHTS`` of each kind), dirauths (relay bandwidth) and
    clients (``client_bw``; client i starts at ``start_time + i ·
    client_interval``). Per-host arrays in the dtypes the YAML loader
    gives."""
    counts = (n_guard, n_middle, n_exit, n_dirauth, n_client)
    h = sum(counts)
    kind = np.repeat(np.arange(5), counts)     # guard middle exit dir client
    relay, client = kind <= 2, kind == 4
    i64 = np.int64
    start = np.full(h, start_time, i64)
    start[client] += np.arange(n_client, dtype=i64) * client_interval
    weight = np.zeros(h, i64)
    weight[relay] = np.asarray(_TOR_WEIGHTS, i64)[kind[relay]]
    bw = np.where(client, client_bw, relay_bw).astype(i64)
    cfg = {
        "ct_cap": ct_cap, "cells_max": _TOR_CELLS_MAX,
        "role": np.select([relay, kind == 3, client], [0, 2, 1], 3).astype(i64),
        "relay_weight": weight,
        "is_guard": kind == 0,
        "is_exit": kind == 2,
        "n_circuits": np.where(client, n_circuits, 0).astype(i64),
        "n_streams": np.where(client, n_streams, 0).astype(i64),
        "mean_stream_cells": np.full(h, mean_stream_cells, np.float64),
        "mean_think_ns": np.full(h, mean_think_ns, np.float64),
        "start_time": start,
        "app": "tor",
    }
    return CompiledExperiment(
        n_hosts=h, seed=seed, end_time=end_time,
        lat_vv=np.full((1, 1), latency_ns, i64),
        loss_vv=np.zeros((1, 1), np.float32),
        host_vertex=np.zeros(h, np.int32), bw_up=bw, bw_dn=bw.copy(),
        model="net", model_cfg=cfg)


def dgram_ring_experiment(n_hosts: int, seed: int, end_time: int, *,
                          latency_ns: int, loss: float, payload: int,
                          interval: int, count: int,
                          start_time: int) -> CompiledExperiment:
    """A dgram ring on one vertex, built in code: host h sends ``count``
    datagrams of ``payload`` bytes, one every ``interval`` ns from
    ``start_time``, to host (h + 1) mod H, over a path that loses ``loss``
    of its packets."""
    i64 = np.int64
    return single_vertex_experiment(
        n_hosts=n_hosts, seed=seed, end_time=end_time, latency_ns=latency_ns,
        loss=loss, model="net", model_cfg={
            "dst": (np.arange(n_hosts, dtype=i64) + 1) % n_hosts,
            "payload": np.full(n_hosts, payload, i64),
            "interval": np.full(n_hosts, interval, i64),
            "count": np.full(n_hosts, count, i64),
            "start_time": np.full(n_hosts, start_time, i64),
            "app": "dgram",
        })


# The transaction payload of configs/rung5_bitcoin5k.yaml, in bytes.
_BTC_TX_SIZE = 400


def bitcoin_experiment(n_hosts: int, seed: int, end_time: int, *,
                       latency_ns: int, bw_bits: int, k: int, n_tx: int,
                       tx_start: int, tx_interval: int) -> CompiledExperiment:
    """A Bitcoin gossip network on one vertex, built in code: the layout of
    ``configs/rung5_bitcoin5k.yaml`` (one host group, a ring-chord peer
    graph of degree ``k``, ``n_tx`` transactions from ``tx_start`` every
    ``tx_interval`` ns at origins drawn from the seed, each of
    ``_BTC_TX_SIZE`` bytes), with the arrays the YAML loader gives
    (``config/experiment.py _gen_bitcoin_cfg``)."""
    from shadow1_tpu_torch.config.experiment import _gen_bitcoin_cfg

    cfg = {"graph": {"kind": "ring_chord", "k": k},
           "tx": {"count": n_tx, "start": tx_start, "interval": tx_interval},
           "tx_size": _BTC_TX_SIZE}
    _gen_bitcoin_cfg(cfg, n_hosts, seed)
    cfg["app"] = "bitcoin"
    return single_vertex_experiment(
        n_hosts=n_hosts, seed=seed, end_time=end_time, latency_ns=latency_ns,
        bw_bits=bw_bits, model="net", model_cfg=cfg)


# The fidelity knobs of ``fidelity_filexfer_experiment``: RED AQM and an
# uplink queue bound on the clients (which upload their flows), a
# downlink queue bound on the servers (which take in 7 uploads), a virtual
# CPU cost on every host (high enough on the clients that events are
# deferred past a window's end) and edge jitter on every vertex pair.
_FID_AQM_MIN, _FID_AQM_MAX, _FID_AQM_PMAX = 5_000, 20_000, 0.1
_FID_CLIENT_TXQ, _FID_SERVER_RXQ = 10_000, 1_500
_FID_SERVER_CPU_NS, _FID_CLIENT_CPU_NS = 2_000, 1_000_000
_FID_JITTER_NS = 1_000_000
# Its fault schedule in ms, per tile g: churn_filexfer.yaml's, compressed
# into 400 ms. (client k of the tile, down, up) cycles, then the outage
# and the 8 % loss ramp of the pop_west <-> pop_east link (both ways, the
# YAML's default).
_FID_HOST_CYCLES = ((2, 100, 200), (2, 280, 360), (3, 150, 250))
_FID_LINK_MS, _FID_RAMP_MS, _FID_RAMP_LOSS = (240, 290), (300, 380), 0.08
_MS = 1_000_000


def fidelity_filexfer_experiment(n_groups: int, seed: int,
                                 end_time: int) -> CompiledExperiment:
    """``tiled_filexfer_experiment`` with every fidelity gate on at once:
    the ``_FID_*`` knobs above and, in every tile, the ``_FID_*`` fault
    schedule (host cycles, link outage, loss ramp)."""
    from shadow1_tpu_torch.fault.schedule import FaultSchedule

    exp = tiled_filexfer_experiment(n_groups, seed, end_time)
    h, per = exp.n_hosts, 1 + _FX_CLIENTS
    server = np.arange(h) % per == 0
    i64 = np.int64
    exp.jitter_vv = np.full_like(exp.lat_vv, _FID_JITTER_NS)
    exp.cpu_ns_per_event = np.where(server, _FID_SERVER_CPU_NS,
                                    _FID_CLIENT_CPU_NS).astype(i64)
    exp.tx_qlen_bytes = np.where(server, 0, _FID_CLIENT_TXQ).astype(i64)
    exp.rx_qlen_bytes = np.where(server, _FID_SERVER_RXQ, 0).astype(i64)
    exp.aqm_min_bytes = np.where(server, 0, _FID_AQM_MIN).astype(i64)
    exp.aqm_max_bytes = np.where(server, 0, _FID_AQM_MAX).astype(i64)
    exp.aqm_pmax = np.where(server, 0.0, _FID_AQM_PMAX)
    g = np.arange(n_groups) * per
    cyc = [(g + k, np.full(n_groups, d * _MS), np.full(n_groups, u * _MS))
           for k, d, u in _FID_HOST_CYCLES]
    both = ([0, 1], [1, 0])
    exp.faults = FaultSchedule(
        host_id=np.concatenate([c[0] for c in cyc]),
        host_down=np.concatenate([c[1] for c in cyc]),
        host_up=np.concatenate([c[2] for c in cyc]),
        link_src=both[0], link_dst=both[1],
        link_t0=[_FID_LINK_MS[0] * _MS] * 2,
        link_t1=[_FID_LINK_MS[1] * _MS] * 2,
        ramp_src=both[0], ramp_dst=both[1],
        ramp_t0=[_FID_RAMP_MS[0] * _MS] * 2,
        ramp_t1=[_FID_RAMP_MS[1] * _MS] * 2,
        ramp_loss=[_FID_RAMP_LOSS] * 2)
    exp.validate()
    return exp


# The arrays of a CompiledExperiment that define a net-model run, in the
# order ``experiment_arrays`` lists them.
_ARRAY_FIELDS = ("lat_vv", "loss_vv", "host_vertex", "bw_up", "bw_dn")
# The fidelity arrays; ``experiment_arrays`` lists one only where it
# differs from the default ``CompiledExperiment`` gives it.
_FIDELITY_FIELDS = ("jitter_vv", "stop_time", "cpu_ns_per_event",
                    "tx_qlen_bytes", "rx_qlen_bytes", "aqm_min_bytes",
                    "aqm_max_bytes", "aqm_pmax")
_FAULT_FIELDS = ("host_id", "host_down", "host_up", "link_src", "link_dst",
                 "link_t0", "link_t1", "ramp_src", "ramp_dst", "ramp_t0",
                 "ramp_t1", "ramp_loss")


def experiment_arrays(exp: CompiledExperiment) -> dict:
    """A JSON-ready record of ``exp``: scalars, the topology and bandwidth
    arrays, the per-host app arrays, the fidelity arrays that differ from
    their defaults (under ``fidelity``) and the fault schedule's arrays
    (under ``faults``, where there is one), each with its dtype, so
    ``experiment_from_arrays`` rebuilds the same experiment on a machine
    that has neither YAML nor GraphML. An experiment with no fidelity knob
    and no fault has neither key.

    ``model_cfg`` scalars (str, bool, int, float: ``app``, tgen's
    ``fixed_size``, Tor's ``ct_cap`` and ``cells_max``) pass as they are,
    arrays (bool ones too) with their dtype. Keys that start with ``_``
    are caches a model memoized into the dict (the reference's Tor keeps
    its path tables under ``_tor_tables``): derived, so left out. Any
    other value is refused."""
    def arr(a):
        a = np.asarray(a)
        return {"dtype": str(a.dtype), "shape": list(a.shape),
                "data": a.ravel().tolist()}

    def cfg_value(k, v):
        if isinstance(v, (str, bool, int, float)):
            return v
        if isinstance(v, np.ndarray):
            return arr(v)
        raise TypeError(f"model_cfg[{k!r}]: {type(v).__name__} is neither "
                        "a scalar nor an array")

    rec = {
        "n_hosts": exp.n_hosts, "seed": exp.seed, "end_time": exp.end_time,
        "model": exp.model,
        "arrays": {f: arr(getattr(exp, f)) for f in _ARRAY_FIELDS},
        "model_cfg": {k: cfg_value(k, v) for k, v in exp.model_cfg.items()
                      if not k.startswith("_")},
    }
    default = CompiledExperiment(
        n_hosts=exp.n_hosts, seed=0, end_time=1, lat_vv=exp.lat_vv,
        loss_vv=exp.loss_vv, host_vertex=exp.host_vertex, bw_up=exp.bw_up,
        bw_dn=exp.bw_dn)
    fid = {f: arr(getattr(exp, f)) for f in _FIDELITY_FIELDS
           if not np.array_equal(getattr(exp, f), getattr(default, f))}
    if fid:
        rec["fidelity"] = fid
    if exp.faults is not None:
        rec["faults"] = {f: arr(getattr(exp.faults, f)) for f in _FAULT_FIELDS}
    return rec


def experiment_from_arrays(rec: dict) -> CompiledExperiment:
    """Inverse of ``experiment_arrays``."""
    def arr(d):
        if not isinstance(d, dict):
            return d
        return np.asarray(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])

    faults = None
    if "faults" in rec:
        from shadow1_tpu_torch.fault.schedule import FaultSchedule

        faults = FaultSchedule(**{f: arr(v) for f, v in rec["faults"].items()})
    return CompiledExperiment(
        n_hosts=rec["n_hosts"], seed=rec["seed"], end_time=rec["end_time"],
        model=rec["model"],
        model_cfg={k: arr(v) for k, v in rec["model_cfg"].items()},
        faults=faults,
        **{f: arr(rec["arrays"][f]) for f in _ARRAY_FIELDS},
        **{f: arr(v) for f, v in rec.get("fidelity", {}).items()},
    )

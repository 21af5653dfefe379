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


# The arrays of a CompiledExperiment that define a net-model run, in the
# order ``experiment_arrays`` lists them.
_ARRAY_FIELDS = ("lat_vv", "loss_vv", "host_vertex", "bw_up", "bw_dn")


def experiment_arrays(exp: CompiledExperiment) -> dict:
    """A JSON-ready record of ``exp`` (no faults, no fidelity knobs):
    scalars, the topology and bandwidth arrays and the per-host app
    arrays, each with its dtype, so ``experiment_from_arrays`` rebuilds
    the same experiment on a machine that has neither YAML nor GraphML."""
    def arr(a):
        a = np.asarray(a)
        return {"dtype": str(a.dtype), "shape": list(a.shape),
                "data": a.ravel().tolist()}

    return {
        "n_hosts": exp.n_hosts, "seed": exp.seed, "end_time": exp.end_time,
        "model": exp.model,
        "arrays": {f: arr(getattr(exp, f)) for f in _ARRAY_FIELDS},
        "model_cfg": {k: (v if isinstance(v, (str, int, float)) else arr(v))
                      for k, v in exp.model_cfg.items()},
    }


def experiment_from_arrays(rec: dict) -> CompiledExperiment:
    """Inverse of ``experiment_arrays``."""
    def arr(d):
        if not isinstance(d, dict):
            return d
        return np.asarray(d["data"], np.dtype(d["dtype"])).reshape(d["shape"])

    return CompiledExperiment(
        n_hosts=rec["n_hosts"], seed=rec["seed"], end_time=rec["end_time"],
        model=rec["model"],
        model_cfg={k: arr(v) for k, v in rec["model_cfg"].items()},
        **{f: arr(rec["arrays"][f]) for f in _ARRAY_FIELDS},
    )

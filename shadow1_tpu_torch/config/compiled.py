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

"""Static tables the oracle builds from a compiled experiment: Tor's
path-selection tables, the NIC queue bounds and RED's thresholds."""

from __future__ import annotations

import numpy as np

from portbench.reference.oracle import rng
from portbench.reference.oracle.consts import SEC

_QLEN_INF = 1 << 62


def qlen_ns_np(qlen_bytes, bw_bits) -> np.ndarray:
    """NIC queue bound in serialization-time ns (0 bytes = unbounded)."""
    q = np.asarray(qlen_bytes, np.int64)
    bw = np.asarray(bw_bits, np.int64)
    return np.where(q > 0, (q * 8 * SEC + bw - 1) // bw, _QLEN_INF)


def aqm_tables_np(exp) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """RED per-host tables (min_ns, span_ns, pmax_thr): thresholds as
    uplink backlog ns, span clamped to at least 1, pmax_thr 0 wherever
    AQM is off."""
    bw = np.asarray(exp.bw_up, np.int64)

    def to_ns(b):
        return (np.asarray(b, np.int64) * 8 * SEC + bw - 1) // bw

    on = np.asarray(exp.aqm_max_bytes) > 0
    min_ns = np.where(on, to_ns(exp.aqm_min_bytes), 0)
    span_ns = np.maximum(np.where(on, to_ns(exp.aqm_max_bytes) - min_ns, 1), 1)
    pmax_thr = np.where(on, rng.prob_threshold(exp.aqm_pmax), np.uint64(0))
    return (min_ns.astype(np.int64), span_ns.astype(np.int64),
            pmax_thr.astype(np.int64))


def _build_tables(cfg) -> dict:
    role = np.asarray(cfg["role"], np.int32)
    weight = np.asarray(cfg["relay_weight"], np.int64)
    is_relay = role == 0

    def cum_ids(member):
        ids = np.nonzero(member)[0].astype(np.int32)
        w = weight[ids]
        assert len(ids) > 0 and (w > 0).all()
        cum = np.cumsum(w)
        assert cum[-1] < 2**31, "total weight must fit i31 for exact randint"
        return ids, cum

    g_ids, g_cum = cum_ids(is_relay & np.asarray(cfg["is_guard"], bool))
    e_ids, e_cum = cum_ids(is_relay & np.asarray(cfg["is_exit"], bool))
    r_ids, r_cum = cum_ids(is_relay)
    dir_ids = np.nonzero(role == 2)[0].astype(np.int32)
    assert len(dir_ids) > 0, "need at least one dirauth"
    return {"guard_ids": g_ids, "guard_cum": g_cum,
            "exit_ids": e_ids, "exit_cum": e_cum,
            "relay_ids": r_ids, "relay_cum": r_cum,
            "dir_ids": dir_ids}

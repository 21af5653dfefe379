"""Structured simulation logger and the per-host tracker snapshot (port
of ``log.py``, the same record schema).

Records are JSON lines on stderr: ``{"wall_s": .., "level": .., "msg":
.., "sim_s": .., "host": .., ...fields}``; a ``level`` filter plays the
reference's ``--log-level`` flag. The engine cannot log from inside a
window, so records are emitted at chunk boundaries; ``tracker_records``
is the Tracker stream: one record per host with its counter snapshot.
"""

from __future__ import annotations

import json
import sys
import time

LEVELS = {"error": 40, "warning": 30, "message": 20, "info": 10, "debug": 0}


def _level_value(level: str) -> int:
    """LEVELS lookup that fails usefully — the reference's --log-level flag
    rejects unknown names with the valid set, not a bare KeyError."""
    try:
        return LEVELS[level]
    except KeyError:
        raise ValueError(
            f"unknown log level {level!r}; valid levels: "
            f"{', '.join(LEVELS)}"
        ) from None


class SimLogger:
    """JSON-lines logger with level filtering and sim-time context."""

    def __init__(self, stream=None, level: str = "message"):
        self.stream = stream if stream is not None else sys.stderr
        self.threshold = _level_value(level)
        self.t0 = time.perf_counter()
        self.n_dropped = 0

    def log(self, level: str, msg: str, sim_ns: int | None = None,
            host: int | None = None, **fields) -> None:
        if _level_value(level) < self.threshold:
            self.n_dropped += 1
            return
        rec = {
            "wall_s": round(time.perf_counter() - self.t0, 3),
            "level": level,
            "msg": msg,
        }
        if sim_ns is not None:
            rec["sim_s"] = round(sim_ns / 1e9, 6)
        if host is not None:
            rec["host"] = int(host)
        rec.update(fields)
        print(json.dumps(rec), file=self.stream, flush=True)

    def error(self, msg, **kw):
        self.log("error", msg, **kw)

    def warning(self, msg, **kw):
        self.log("warning", msg, **kw)

    def message(self, msg, **kw):
        self.log("message", msg, **kw)

    def info(self, msg, **kw):
        self.log("info", msg, **kw)

    def debug(self, msg, **kw):
        self.log("debug", msg, **kw)


def tracker_records(engine, st) -> list[dict]:
    """Per-host tracker snapshot (the reference Tracker's analogue).

    Reads the per-host counter columns off the device once and emits one
    dict per host: NIC byte counters, queued events, cpu busy-time, plus every
    per-host column the model summary exposes. Counters are lifetime
    absolutes; interval deltas are tools/heartbeat_report.py's job."""
    import numpy as np

    sim_ns = int(st.win_start)
    cols: dict[str, np.ndarray] = {}
    # evbuf.kind is [ev_cap, H] (host-minor layout): reduce the slot axis.
    cols["pending_events"] = (st.evbuf.kind != 0).sum(dim=0).cpu().numpy()
    cols["cpu_busy_ns"] = st.cpu_busy.cpu().numpy()
    # Model summaries own their key namespace (net exports nic_tx_bytes /
    # nic_rx_bytes per host; apps export their per-host counters).
    for k, v in engine.model_summary(st).items():
        v = np.asarray(v)
        if v.ndim == 1 and v.shape[0] == engine.exp.n_hosts:
            cols[k] = v
    from shadow1_tpu_torch.telemetry.registry import REC_TRACKER

    return [
        {"type": REC_TRACKER, "sim_s": round(sim_ns / 1e9, 6), "host": h,
         **{k: int(v[h]) for k, v in cols.items()}}
        for h in range(engine.exp.n_hosts)
    ]

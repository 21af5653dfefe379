"""The port's heartbeat, phase profiler, registry and logger against the
JAX package's, on the CPU.

* ``obs.run_with_heartbeat`` on a small PHOLD under host churn (the ring,
  the digest words, a host probe and the link accumulator on), in chunks
  of 4 windows: every heartbeat record has the reference's keys, block by
  block, and its deterministic fields (windows, sim time, metric deltas,
  drops, faults, work, fill) equal the JAX run's; the ring, flow and link
  records are the reference's; the reference's ``heartbeat_report``
  reads the port's log and makes the same tables of it.
* ``to_prometheus`` / ``normalize`` / ``ExpositionServer`` give the
  reference's text for the same metrics; ``tracker_records`` equal the
  reference's for the same state.
* ``PhaseProfiler``'s Chrome trace round-trips through JSON, and a
  ``device_trace`` of a window holds the four window phases' spans.
* ``SimLogger`` checks its level; the recovery planes' hooks run.
"""

import io
import json
import urllib.request

import pytest

from shadow1_tpu import log as log_j
from shadow1_tpu import obs as obs_j
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.telemetry import registry as reg_j
from shadow1_tpu.tools import heartbeat_report
from shadow1_tpu_torch import ckpt, log as log_t, obs as obs_t
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.telemetry import registry as reg_t
from shadow1_tpu_torch.telemetry.profiler import (
    TRACE_FILE,
    WINDOW_PHASES,
    PhaseProfiler,
    device_trace,
)
from tests.test_torch_fault import _phold_churn_exp
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import _one_thread  # noqa: F401

WINDOWS, CHUNK = 20, 4
PARAMS = dict(metrics_ring=CHUNK, state_digest=1, probes=((1, -1), (5, -1)),
              link_telem=1)
# Heartbeat fields that depend on the wall clock.
WALL = ("wall_s", "events_per_sec", "sim_per_wall")


@pytest.fixture(scope="module")
def runs():
    """(port engine, port state, port heartbeat, JAX engine, JAX state,
    JAX heartbeat): run_with_heartbeat in chunks of CHUNK windows."""
    eng_t = EngineT(_phold_churn_exp(), EngineParamsT(**PARAMS), device="cpu")
    st_t, hb_t = obs_t.run_with_heartbeat(eng_t, n_windows=WINDOWS,
                                          every_windows=CHUNK, stream=False)
    eng_j = EngineJ(jax_experiment(_phold_churn_exp()),
                    EngineParamsJ(**PARAMS))
    st_j, hb_j = obs_j.run_with_heartbeat(eng_j, n_windows=WINDOWS,
                                          every_windows=CHUNK, stream=False)
    return eng_t, st_t, hb_t, eng_j, st_j, hb_j


def _shape(rec):
    return {k: _shape(v) if isinstance(v, dict) else None
            for k, v in rec.items()}


def test_heartbeat_records_match_reference(runs):
    _, _, hb_t, _, _, hb_j = runs
    assert len(hb_t.records) == len(hb_j.records) == WINDOWS // CHUNK
    for rt, rj in zip(hb_t.records, hb_j.records):
        assert _shape(rt) == _shape(rj)
        assert ({k: v for k, v in rt.items() if k not in WALL}
                == {k: v for k, v in rj.items() if k not in WALL})
    assert any("faults" in r for r in hb_t.records)
    assert any(r["drops"]["total"] > 0 for r in hb_t.records)
    assert hb_t.ring_records == hb_j.ring_records
    assert hb_t.flow_records == hb_j.flow_records
    assert hb_t.link_records == hb_j.link_records
    assert len(hb_t.ring_records) == WINDOWS
    assert len(hb_t.link_records) > 0


def test_heartbeat_stream_and_report(runs, tmp_path):
    """The printed stream is the records, one JSON object a line; the
    reference's heartbeat_report reads it and makes the tables it makes of
    the reference's own stream (the wall-clock columns aside)."""
    eng_t, _, _, eng_j, _, _ = runs
    logs = {}
    for name, mod, eng in (("port", obs_t, eng_t), ("jax", obs_j, eng_j)):
        buf = io.StringIO()
        mod.run_with_heartbeat(eng, n_windows=WINDOWS, every_windows=CHUNK,
                               stream=buf)
        path = tmp_path / f"{name}.log"
        path.write_text(buf.getvalue())
        logs[name] = path
    lines = logs["port"].read_text().splitlines()
    recs = [json.loads(s) for s in lines]
    assert {r["type"] for r in recs} == {"heartbeat", "ring", "flow", "link"}
    out = io.StringIO()
    got = heartbeat_report.summarize(heartbeat_report.load_records(
        str(logs["port"])), out=out)
    want = heartbeat_report.summarize(heartbeat_report.load_records(
        str(logs["jax"])), out=io.StringIO())
    wall = ("wall_s", "events_per_sec_mean", "sim_per_wall_mean")
    assert set(got) == set(want) >= {"drops", "ring", "work", "flows",
                                     "links", *wall}
    assert ({k: v for k, v in got.items() if k not in wall}
            == {k: v for k, v in want.items() if k not in wall})
    assert heartbeat_report.main([str(logs["port"]), "--ring-csv",
                                  str(tmp_path / "ring.csv")]) == 0


def test_prometheus_and_normalize_match_reference(runs):
    _, st_t, _, _, st_j, _ = runs
    m = EngineT.metrics_dict(st_t)
    assert m == EngineJ.metrics_dict(st_j)
    m["an_extra"] = 3
    assert reg_t.normalize(m) == reg_j.normalize(m)
    assert (reg_t.to_prometheus(m, labels={"run": 'a"b'})
            == reg_j.to_prometheus(m, labels={"run": 'a"b'}))
    serve = {"jobs_done": 2, "oldest_wait_s": 0.25}
    assert (reg_t.to_prometheus(serve, prefix="s", specs=reg_t.SERVE_SPECS)
            == reg_j.to_prometheus(serve, prefix="s",
                                   specs=reg_j.SERVE_SPECS))
    for name in ("RING_FIELDS", "PROBE_FIELDS", "LINK_FIELDS", "DROP_FIELDS",
                 "HOST_FIELDS", "RECORD_TYPES", "METRIC_SPECS"):
        assert getattr(reg_t, name) == getattr(reg_j, name), name


def test_exposition_server_serves_the_text(runs):
    _, st_t, _, _, _, _ = runs
    m = EngineT.metrics_dict(st_t)
    srv = reg_t.ExpositionServer(lambda: m, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = r.read().decode()
    finally:
        srv.stop()
    assert body == reg_j.to_prometheus(m)


def test_tracker_records_match_reference(runs):
    eng_t, st_t, _, eng_j, st_j, _ = runs
    got = log_t.tracker_records(eng_t, st_t)
    assert got == log_j.tracker_records(eng_j, st_j)
    assert len(got) == eng_t.exp.n_hosts
    assert {r["type"] for r in got} == {"tracker"}


def test_phase_profiler_trace_round_trip(tmp_path):
    prof = PhaseProfiler()
    with prof.span("run-chunk", windows=3):
        with prof.span("drain"):
            pass
    prof.instant("mark", n=1)
    path = tmp_path / "t.json"
    prof.write(str(path))
    trace = json.loads(path.read_text())
    assert trace == json.loads(json.dumps(prof.chrome_trace()))
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["drain", "run-chunk"]
    assert xs[1]["args"] == {"windows": 3} and xs[1]["dur"] >= xs[0]["dur"]
    assert prof.span_names() == ["drain", "run-chunk"]


def test_device_trace_holds_window_phases(tmp_path):
    eng = EngineT(_phold_churn_exp(), EngineParamsT(**PARAMS), device="cpu")
    st = eng.init_state()
    prof = PhaseProfiler()
    with device_trace(str(tmp_path), prof):
        ckpt.run_chunked(eng, st, n_windows=2, profiler=prof)
    trace = json.loads((tmp_path / TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    for want in (*WINDOW_PHASES.values(), "run-chunk", "device-trace"):
        assert want in names, want
    assert prof.span_names() == ["run-chunk", "device-trace"]


def test_sim_logger_levels():
    for mod in (log_t, log_j):
        with pytest.raises(ValueError, match="valid levels: error"):
            mod.SimLogger(level="verbose")
    buf = io.StringIO()
    lg = log_t.SimLogger(stream=buf, level="warning")
    lg.info("hidden")
    lg.warning("shown", sim_ns=1_500_000_000, host=3, k=1)
    rec = json.loads(buf.getvalue())
    assert lg.n_dropped == 1
    assert {k: rec[k] for k in ("level", "msg", "sim_s", "host", "k")} == {
        "level": "warning", "msg": "shown", "sim_s": 1.5, "host": 3, "k": 1}
    assert set(rec) == {"wall_s", "level", "msg", "sim_s", "host", "k"}


def test_recovery_hooks_are_refused(runs):
    """The name is historical: the recovery planes' hooks were refused
    until that slice. Each is accepted now, and a run under it gives the
    plain run's heartbeat records (nothing overflows, nothing drains)."""
    from shadow1_tpu_torch.preempt import DrainHandler
    from shadow1_tpu_torch.tune import CapController
    from shadow1_tpu_torch.txn import OverflowGuard

    eng_t = runs[0]
    _, plain = obs_t.run_with_heartbeat(eng_t, n_windows=2, every_windows=1,
                                        stream=False)
    for kw in (dict(guard=OverflowGuard(eng_t, mode="halt")),
               dict(controller=CapController(eng_t, eng_t.at_caps)),
               dict(selfcheck=True), dict(drain=DrainHandler())):
        _, hb = obs_t.run_with_heartbeat(eng_t, n_windows=2, every_windows=1,
                                         stream=False, **kw)
        assert [{k: v for k, v in r.items() if k not in WALL + ("fill",)}
                for r in hb.records] == [
            {k: v for k, v in r.items() if k not in WALL + ("fill",)}
            for r in plain.records]

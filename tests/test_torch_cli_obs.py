"""The port's CLI run flags, in subprocesses on ``--device cpu``, against
the JAX package's CLI.

``configs/churn_filexfer.yaml`` (8 hosts on two PoPs; 40 ms windows) for
8 windows with heartbeats every 4, the link accumulator, two watched
flows and the digest words on:

* ``--watch`` and ``--link-telem on`` print the flow, link and ring
  records that ``python -m shadow1_tpu --engine tpu`` prints for the same
  flags, and the result line has the reference's keys and metrics;
* ``--save-state`` at window 4, then ``--resume`` for 4 more, prints what
  the straight run prints for windows 4-7 and ends with its metrics; the
  JAX CLI's ``--save-state`` snapshot resumes in the port as the port's
  own does;
* ``--ckpt`` survives a child killed by ``SHADOW1_OBS_CRASH_AT_NS`` right
  after its window-4 snapshot (backoff 0): the respawned child resumes
  from the lineage and the run ends equal to the straight one;
* ``--tracker``, ``--trace`` and ``--profile`` write their files;
* the flags of the recovery planes run, and so does ``--engine sharded``
  (a world of one rank); ``--engine cpu --device cuda`` is refused as a
  contradiction, as are the reference's ambiguous combinations.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CFG = str(ROOT / "configs" / "churn_filexfer.yaml")
WINDOW_NS = 40_000_000
FLAGS = ["--heartbeat", "4", "--link-telem", "on", "--watch", "server:0",
         "--watch", "client[2]:0", "--state-digest", "on"]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "SHADOW1_SUPERVISE_BACKOFF_S": "0"}


def _port(*args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "shadow1_tpu_torch", CFG, "--device", "cpu",
         *args], cwd=ROOT, env={**ENV, **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _done(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    recs = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    return recs[:-1], recs[-1], err


def _of(recs, *types):
    return [r for r in recs if r.get("type") in types]


def _steady(recs):
    """The records without their wall-clock fields."""
    wall = ("wall_s", "events_per_sec", "sim_per_wall", "wall_seconds")
    return [{k: v for k, v in r.items() if k not in wall} for r in recs]


def _spans(path):
    """A PhaseProfiler trace's spans: name → [(start, end) µs]."""
    out = {}
    for e in json.loads(Path(path).read_text())["traceEvents"]:
        if e["ph"] == "X":
            out.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI, the port's straight run (snapshot at window 8) and its
    first half (snapshot at window 4), started together."""
    d = tmp_path_factory.mktemp("cli")
    jax_cli = subprocess.Popen(
        [sys.executable, "-m", "shadow1_tpu", CFG, "--engine", "tpu",
         "--windows", "8", "--summary", "--save-state", str(d / "j8.npz"),
         *FLAGS], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    straight = _port("--windows", "8", "--save-state", str(d / "p8.npz"),
                     "--tracker", str(d / "tracker.jsonl"),
                     "--trace", str(d / "phases.json"), *FLAGS)
    half = _port("--windows", "4", "--save-state", str(d / "p4.npz"), *FLAGS)
    out = {"dir": d, "straight": _done(straight), "half": _done(half)}
    jout, jerr = jax_cli.communicate(timeout=600)
    assert jax_cli.returncode == 0, jerr[-3000:]
    out["jax"] = ([json.loads(s) for s in jerr.splitlines()
                   if s.startswith("{")],
                  json.loads(jout.strip().splitlines()[-1]))
    return out


def test_watch_and_link_records_match_jax_cli(runs):
    recs, res, _ = runs["straight"]
    jrecs, jres = runs["jax"]
    for kind in ("flow", "link", "ring", "flow_gap", "ring_gap"):
        assert _of(recs, kind) == _of(jrecs, kind), kind
    assert len(_of(recs, "flow")) == 8 * 2
    assert [r["window"] for r in _of(recs, "link")] == [3, 3, 7, 7]
    hb, jhb = _of(recs, "heartbeat"), _of(jrecs, "heartbeat")
    assert [sorted(r) for r in hb] == [sorted(r) for r in jhb]
    assert [r["delta"] for r in hb] == [r["delta"] for r in jhb]
    assert set(res) >= set(jres) | {"device", "summary"}
    assert res["device"] == "cpu" and res["engine"] == jres["engine"]
    for k in ("hosts", "window_ns", "windows", "sim_seconds", "resumed",
              "caps", "metrics", "drops", "work", "summary"):
        assert res.get(k) == jres.get(k), k


def test_save_state_then_resume_equals_straight(runs):
    d = runs["dir"]
    recs, res, _ = runs["straight"]
    half_recs, half_res, _ = runs["half"]
    assert half_res["windows"] == 4 and not half_res["resumed"]
    rest, res2, _ = _done(_port("--resume", str(d / "p4.npz"), "--windows",
                                "4", "--trace", str(d / "resumed.json"),
                                *FLAGS))
    assert res2["resumed"] and res2["windows"] == 4
    # The kernel build is timed before the template state's init.
    spans = _spans(d / "resumed.json")
    assert len(spans["compile"]) == 1
    assert spans["compile"][0][1] <= spans["run-chunk"][0][0]
    assert "init" not in spans
    assert res2["metrics"] == res["metrics"]
    for kind in ("ring", "flow"):
        assert _of(half_recs, kind) + _of(rest, kind) == _of(recs, kind)
    assert _of(rest, "link") == _of(recs, "link")[2:]
    # The run's rates cover this invocation only.
    assert res2["events_per_sec"] * res2["wall_seconds"] == pytest.approx(
        res["metrics"]["events"] - half_res["metrics"]["events"], rel=0.01)


def test_jax_snapshot_resumes_like_the_ports(runs):
    d = runs["dir"]
    procs = [_port("--resume", str(d / f"{who}8.npz"), "--windows", "2",
                   *FLAGS) for who in ("j", "p")]
    (jr, jres, _), (pr, pres, _) = (_done(p) for p in procs)
    assert _steady(jr + [jres]) == _steady(pr + [pres])
    assert {r["type"] for r in jr} == {"heartbeat", "ring", "flow", "link"}
    assert jres["metrics"]["windows"] == 10 and jres["resumed"]


def test_ckpt_survives_injected_crash(runs):
    d = runs["dir"]
    path = d / "c.npz"
    proc = _port("--ckpt", str(path), "--ckpt-every-s", "0", "--windows", "8",
                 *FLAGS, env={"SHADOW1_OBS_CRASH_AT_NS": str(4 * WINDOW_NS)})
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    assert "child died rc=41" in err
    resume = [json.loads(s) for s in err.splitlines()
              if s.startswith('{"type": "resume"')]
    assert [r["win_start"] for r in resume] == [4 * WINDOW_NS]
    recs = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    straight, res, _ = runs["straight"]
    assert recs[-1]["metrics"] == res["metrics"] and recs[-1]["resumed"]
    for kind in ("ring", "flow"):
        assert _of(recs, kind) == _of(straight, kind), kind
    # A finished supervised run leaves no lineage behind.
    assert not [p for p in os.listdir(d) if p.startswith("c.npz")]


def test_tracker_and_trace_files(runs):
    d = runs["dir"]
    tracker = [json.loads(s) for s in (d / "tracker.jsonl").read_text()
               .splitlines()]
    assert [r["host"] for r in tracker] == list(range(8))
    assert all(r["type"] == "tracker" and r["sim_s"] == 0.32
               for r in tracker)
    spans = _spans(d / "phases.json")
    assert len(spans["run-chunk"]) == 2 and "checkpoint" not in spans
    assert {"init", "compile", "drain"} <= set(spans)
    # One compile span, ended before the init span, which launches kernels.
    assert len(spans["compile"]) == 1
    assert spans["compile"][0][1] <= spans["init"][0][0]


def test_profile_writes_device_trace(tmp_path, capsys):
    import torch

    from shadow1_tpu_torch import cli

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main([CFG, "--device", "cpu", "--windows", "2",
                         "--profile", str(tmp_path)]) == 0
    finally:
        torch.set_num_threads(n)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["windows"] == 2
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"phase:prepare", "phase:rounds", "phase:deliver",
            "phase:telem", "run-chunk"} <= names
    assert (tmp_path / "phases.trace.json").exists()


@pytest.mark.parametrize("flags,item", [
    (["--auto-caps"], "item 5"), (["--on-overflow", "retry"], "item 5"),
    (["--on-oom", "downshift"], "item 5"), (["--selfcheck"], "item 5"),
    (["--watchdog-s", "30"], "item 5"), (["--fleet"], "sweep:"),
    (["--on-lane-fail", "quarantine"], "need --fleet"),
    (["--lane-finalize"], "need --fleet"),
    (["--engine", "cpu", "--device", "cuda"], "contradicts"),
    (["--engine", "sharded"], "item 6"),
    (["--ckpt", "x.npz", "--resume", "y.npz", "--windows", "3"],
     "ambiguous"),
    (["--ckpt-keep", "0"], "ckpt-keep"),
    (["--watch", "clinet:0"], "did you mean 'client'"),
])
def test_refused_flags_name_their_item(flags, item, capsys):
    """The name is historical for the recovery planes' flags ("item 5"),
    refused until that slice: each is accepted now and the run (one
    window, in process) ends with its result line. The fleet's flags run
    since the fleet slice: ``--fleet`` on this solo config (no ``sweep:``
    section) is the reference's structured ``fleet_config`` rejection
    (EXIT_CONFIG), and the lane policies without ``--fleet`` are refused
    as they are there. The sharded engine ("item 6") runs since the shard
    slice: launched alone, a world of one rank, whose one window ends in
    its result line. The reference's ambiguous combinations stay refused;
    the numpy oracle (``--engine cpu``) runs on the host, so a CUDA
    ``--device`` beside it is refused as a contradiction."""
    import torch

    from shadow1_tpu_torch import cli

    if item in ("item 5", "item 6"):
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            assert cli.main([CFG, "--device", "cpu", "--windows", "1",
                             *flags]) == 0
        finally:
            torch.set_num_threads(n)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["windows"] == 1 and res["metrics"]["windows"] == 1
        return
    if flags == ["--fleet"]:
        assert cli.main([CFG, "--device", "cpu", *flags]) == 2
        out = capsys.readouterr()
        rec = json.loads(out.out.strip().splitlines()[-1])
        assert rec["error"] == "fleet_config" and rec["kind"] == "schema"
        assert item in rec["message"] and item in out.err
        return
    with pytest.raises(SystemExit) as e:
        cli.main([CFG, "--device", "cpu", *flags])
    assert e.value.code == 2
    assert item in capsys.readouterr().err

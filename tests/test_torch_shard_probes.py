"""The tools on the sharded engine, on gloo CPU ranks: churnprobe's
verdict over cpu, tpu and sharded:2 equals the JAX churnprobe's;
shardprobe's ``scale`` (1 and 2 ranks) and ``overhead`` rows and
crossover's rows are well formed (their shape, not a time); the probes'
pointers name the port's paritytrace command."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from shadow1_tpu_torch.tools import churnprobe as churn_t
from shadow1_tpu_torch.tools import crossover, shardprobe

ROOT = Path(__file__).resolve().parents[1]


def run(module, *argv) -> tuple[int, list]:
    """``module.main(argv)`` in process: (exit code, JSON stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = module.main(list(argv))
    return rc, [json.loads(s) for s in buf.getvalue().splitlines()
                if s.startswith(("{", "["))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_churnprobe_verdict_equals_the_reference():
    """churn_filexfer's faults over a few windows: digest parity across
    the three sides, the accounting closed — the reference's verdict (the
    JAX churnprobe runs in a process of its own meanwhile)."""
    argv = (str(ROOT / "configs" / "churn_filexfer.yaml"), "--sides",
            "cpu,tpu,sharded:2", "--windows", "20", "--chunk", "10")
    ref = subprocess.Popen(
        [sys.executable, "-m", "shadow1_tpu.tools.churnprobe", *argv],
        cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        rc, got = run(churn_t, *argv, "--device", "cpu")
        out, _ = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert (rc, got[-1]) == (ref.returncode,
                             json.loads(out.strip().splitlines()[-1]))
    v = got[-1]
    assert rc == 0 and v["ok"] and v["digest_windows_compared"] == {
        "tpu": 20, "sharded:2": 20}
    assert all(a["closes"] for a in v["accounting"].values())


def test_churnprobe_needs_faults():
    rc, out = run(churn_t, str(ROOT / "configs" / "rung1_filexfer.yaml"),
                  "--device", "cpu")
    assert rc == 2 and "faults" in out[-1]["error"]


def test_shardprobe_scale_rows():
    rc, rows = run(shardprobe, "scale", "--devices", "1,2", "--windows", "2")
    assert rc == 0 and [r["n_dev"] for r in rows] == [1, 2]
    for r in rows:
        for w in ("tor1k", "dense2k"):
            assert set(r[w]) >= {"wall_s", "events", "events_per_sec",
                                 "x2x_max_fill", "ev_overflow"}
            assert r[w]["ev_overflow"] == 0
        assert r["dense2k"]["events"] == rows[0]["dense2k"]["events"] > 0


def test_shardprobe_overhead_row():
    rc, (row,) = run(shardprobe, "overhead", "--windows", "2", "--device",
                     "cpu")
    assert rc == 0 and row["events_match"] and row["device"] == "cpu"
    assert set(row["plain"]) == set(row["rank1"])


def test_crossover_rows():
    """The dense mesh at two sizes: the batched engine (a child process
    each) and the C++ comparator count the same events."""
    rc, rows = run(crossover, "--hosts", "200,400", "--windows", "3",
                   "--device", "cpu")
    assert rc == 0 and [r["n_hosts"] for r in rows] == [200, 400]
    for r in rows:
        assert r["events_match"] and r["events_per_sec"] > 0
        assert r["cpp_events_per_sec"] > 0 and "tpu_vs_cpp" in r


def test_crossover_doc_is_the_config():
    from shadow1_tpu_torch.config.experiment import parse_config

    text = (ROOT / "configs" / "dense_tgen50k.yaml").read_text()
    assert crossover.dense_doc(50_000) == parse_config(text)


def test_probes_point_at_paritytrace():
    """chaosprobe's verdicts and memprobe's sub-batch hint name the port's
    paritytrace command, as the reference's name its own."""
    for tool in ("chaosprobe", "memprobe"):
        text = (ROOT / "shadow1_tpu_torch" / "tools" / f"{tool}.py"
                ).read_text()
        assert "tools.paritytrace" in text and "6d" not in text, tool
    from shadow1_tpu_torch.tools.chaosprobe import _paritytrace

    assert _paritytrace("c.json", "tpu cpu", 40) == (
        "python -m shadow1_tpu_torch.tools.paritytrace c.json tpu cpu "
        "--windows 40")


@pytest.mark.slow
def test_churnprobe_whole_horizon():
    """churn_filexfer whole (150 windows, every fault of its schedule):
    the port's sharded:2 digest stream equals the oracle's and the solo
    engine's in every window. (The JAX ShardedEngine over 2 devices
    leaves them at window 28: ROADMAP Queue C.)"""
    rc, out = run(churn_t, str(ROOT / "configs" / "churn_filexfer.yaml"),
                  "--sides", "cpu,tpu,sharded:2", "--device", "cpu")
    v = out[-1]
    assert rc == 0 and v["ok"], v
    assert v["digest_windows_compared"] == {"tpu": 150, "sharded:2": 150}
    assert v["counters"]["sharded:2"]["host_restarts"] > 0

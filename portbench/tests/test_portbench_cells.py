"""The whole run on the CPU at test sizes: tiny copies of the benchmark's
configurations (``tiny.py``) through set-up, the window and the check,
with the kernels' plain versions; the reference equal to the port; each
fault the cells can have planted in the program turns ``correct`` false;
each configuration's control differs from its reference.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import pytest

from portbench.tests.tiny import manifest, run_tiny, tiny_configs

SEED = 2**31 + 77   # past 32 signed bits, as a benchmark seed may be


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def checks(out: dict) -> dict:
    return {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("cell", ["phold.tiny", "tor.tiny"])
def test_reference_equals_the_port(cell):
    out = run_tiny(cell, SEED)
    assert out["correct"], out["checks"]
    assert set(checks(out)) == {"metric_fields", "ring_fields",
                                "summary_values", "digest_words",
                                "pass_drift"}
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"events_per_s", "peak_mem_gib", "setup_s"}
    assert out["metrics"]["events_per_s"]["value"] > 0


def test_traced_run_reports_the_per_layer_metrics():
    out = run_tiny("phold.tiny", SEED + 1, trace=True)
    assert out["correct"]
    names = {m["name"] for m in manifest()["per_layer"]}
    # The CPU has no device records: the device readers return nothing.
    device_only = {"pop_roofline_pct", "kernel_share_pct", "device_idle_pct"}
    assert set(out["metrics"]) == names - device_only
    assert out["metrics"]["device_ops_per_round"]["value"] > 50
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["phold.tiny", "tor.tiny"])
def test_a_planted_fault_is_not_correct(cell, fault):
    out = run_tiny(cell, SEED + 2, fault=fault)
    assert not out["correct"], (cell, fault)
    assert sum(checks(out).values()) > 0


@pytest.mark.parametrize("config", ["phold.tiny", "tor.tiny"])
def test_the_control_is_not_correct(config):
    from portbench.harness import compare_outputs, reference_module

    cfg = tiny_configs()[config]
    ref = reference_module(cfg["reference"])
    seeds = [SEED, SEED + 1]
    want = ref.expected(cfg["experiment"], seeds, 12, device="cpu")
    again = ref.expected(cfg["experiment"], seeds, 12, device="cpu")
    got = ref.expected(cfg["experiment"], seeds, 12, device="cpu",
                       control=cfg["control"])
    assert sum(compare_outputs(again, want).values()) == 0
    assert sum(compare_outputs(got, want).values()) > 0


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from portbench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "phold.lp1m", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc == harness.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """Needs the card: a short run of the PHOLD cell through ``run.py``,
    correct, with the contract's last line."""
    import json
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.harness import ROOT

    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "phold.lp1m",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"

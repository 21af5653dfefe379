"""The Bitcoin cell (``configs/bitcoin5k.json``) on the CPU at test size,
and its reference:

* ``oracle_lanes`` (the frozen oracle, one seed per worker process)
  equals ``oracle`` seed for seed, and reproduces the golden the JAX
  engine wrote for the configuration (``golden/net_bitcoin5k.json``:
  seed 55, 60 windows, every counter, digest word and summary array);
* a tiny copy of the cell (256 hosts, 4 lanes, windows 44-51 of the
  flood) through the whole harness is correct; each of ``tiny.py``'s
  planted faults makes it not correct; its control differs from its
  reference. The copy caps a window at 64 rounds (it needs 25 at most),
  so the lanes that ``half`` stops from popping spin 64 rounds a window,
  not 1,024, and a faulty run's near-empty passes fill 2 ms of pass time,
  not 50;
* a traced run reads both of the Bitcoin app's per-layer metrics above 0.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import copy
import hashlib
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "shadow1_tpu_torch" / "golden"
SEED = 2**31 + 77   # past 32 signed bits, as a benchmark seed may be
NAME = "bitcoin.tiny"
CELL = {"config": NAME, "traffic": "seeds4", "lanes": 4, "start_window": 44,
        "span_windows": 8}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "portbench/configs/bitcoin5k.json").read_text())
    # Ring-chord k 8 reaches ±64: more than 128 hosts keep the chords apart.
    cfg["experiment"]["hosts"][0]["count"] = 256
    cfg["experiment"]["engine"]["max_rounds"] = 64
    return cfg


def manifest() -> dict:
    m = tiny.manifest()
    m["configs"] = [{"name": NAME, "source": "https://example.org/tiny",
                     "file": f"portbench/configs/{NAME}.json",
                     "reduced": [], "why": "a tiny copy for the CPU tests"}]
    m["workloads"] = [{"name": NAME, "config": NAME,
                       "traffic": CELL["traffic"], "chips": 1,
                       "why": "tiny"}]
    return m


def run_tiny(seed: int, trace: bool = False, fault: str | None = None,
             seconds: float = 0.05) -> dict:
    """One run of the tiny Bitcoin cell on the CPU: the result line's
    object."""
    from portbench.harness import run_cell

    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        for sub in ("configs", "workloads"):
            (root / "portbench" / sub).mkdir(parents=True)
        (root / f"portbench/configs/{NAME}.json").write_text(
            json.dumps(tiny_config()))
        (root / f"portbench/workloads/{NAME}.json").write_text(
            json.dumps(CELL))
        with tiny.planted(fault):
            return run_cell(NAME, seed, seconds, trace, "cpu",
                            manifest=manifest(), root=root,
                            log=lambda s: None)


def checks(out: dict) -> dict:
    return {k: c["value"] for k, c in out["checks"].items()}


def sha256(a) -> str:
    return hashlib.sha256(np.asarray(a, "<i8").tobytes()).hexdigest()


def test_oracle_lanes_equals_the_oracle():
    from portbench.harness import compare_outputs
    from portbench.reference import oracle, oracle_lanes

    doc = tiny_config()["experiment"]
    seeds = [SEED, SEED + 1, SEED + 2]
    want = oracle.expected(doc, seeds, 50)
    got = oracle_lanes.expected(doc, seeds, 50, device="cpu")
    assert sum(compare_outputs(got, want).values()) == 0
    for g, w in zip(got, want, strict=True):
        assert g["metrics"] == w["metrics"] and g["ring"] == w["ring"]
        assert set(g["summary"]) == set(w["summary"])
        for k, v in w["summary"].items():
            assert np.array_equal(np.asarray(g["summary"][k]), np.asarray(v))
    # The seeds draw other origins: the lanes are not one run three times.
    assert len({sha256(g["summary"]["seen_time"]) for g in got}) == 3


def test_oracle_lanes_reproduce_the_bitcoin5k_golden():
    from portbench.reference import oracle_lanes

    gold = json.loads((GOLDEN / "net_bitcoin5k.json").read_text())
    build = gold["build"]["bitcoin_experiment"]
    assert (build["seed"], build["n_hosts"], build["end_time"]) == (
        55, 5000, 60_000_000_000)
    doc = copy.deepcopy(json.loads(
        (ROOT / "portbench/configs/bitcoin5k.json").read_text())["experiment"])
    doc["general"]["stop_time"] = "60 s"
    out = oracle_lanes.expected(doc, [55], gold["windows"])[0]
    assert out["metrics"] == {k: gold["metrics"][k] for k in out["metrics"]}
    assert len(out["metrics"]) >= 20 and out["metrics"]["events"] == 143_808
    words = [[r[f] for f in gold["digest_fields"]] for r in out["ring"]]
    assert words == gold["digests"]
    assert set(out["summary"]) == set(gold["summary"])
    for k, v in out["summary"].items():
        a = np.asarray(v)
        assert int(a.sum()) == int(gold["summary"][k]), k
        if a.ndim:
            assert sha256(a) == gold["sha256"][k], k


def test_tiny_bitcoin_cell_is_correct():
    out = run_tiny(SEED)
    assert out["correct"], out["checks"]
    assert set(checks(out)) == {"metric_fields", "ring_fields",
                                "summary_values", "digest_words",
                                "pass_drift"}
    assert sum(checks(out).values()) == 0
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert out["metrics"]["events_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(fault):
    out = run_tiny(SEED + 2, fault=fault, seconds=0.002)
    assert not out["correct"], fault
    assert sum(checks(out).values()) > 0


def test_the_control_is_not_correct():
    from portbench.harness import compare_outputs, reference_module

    cfg = tiny_config()
    ref = reference_module(cfg["reference"])
    seeds = [SEED, SEED + 1]
    n = CELL["start_window"] + CELL["span_windows"]
    want = ref.expected(cfg["experiment"], seeds, n, device="cpu")
    again = ref.expected(cfg["experiment"], seeds, n, device="cpu")
    got = ref.expected(cfg["experiment"], seeds, n, device="cpu",
                       control=cfg["control"])
    assert sum(compare_outputs(again, want).values()) == 0
    assert sum(compare_outputs(got, want).values()) > 0


def test_traced_run_reads_the_bitcoin_metrics():
    out = run_tiny(SEED + 3, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["round_ms.btc"]["value"] > 0
    # At least the K = 8 announcements of a transaction's first sight.
    assert out["metrics"]["btc_pushes_per_round"]["value"] > 1

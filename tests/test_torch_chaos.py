"""The port's kill-anywhere chaos harness
(``shadow1_tpu_torch/tools/chaosprobe.py``) on the CPU.

* Three solo trials (a drain, a torn head, a corrupt head), run at once
  (``--jobs 3``), on a small PHOLD config with ``--device cpu
  --no-oracle``: every trial ends bit-identical to the straight run, and
  the straight run's digest stream equals the JAX CLI's ``--state-digest
  on`` stream of the same config.
* With no card and no ``--device`` a solo run exits 1 before anything
  runs, with ``--no-oracle`` or without it (without it, the run would
  cross-check the straight stream against the oracle,
  ``tests/test_torch_oracle_tools.py``).
* ``slow``: the full solo matrix (20 trials, one after another), the
  fleet matrices under ``--on-overflow retry`` (an under-sized
  ``ev_cap``) and under ``--on-lane-fail quarantine``
  (``--expect-quarantine 1``), and four serve-daemon kill trials, one of
  each kind.

Tolerance: none (digest words).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from shadow1_tpu_torch.tools import chaosprobe

ROOT = Path(__file__).resolve().parents[1]
PHOLD = str(ROOT / "configs" / "serve_phold.yaml")
WINDOWS, CHUNK = 40, 10
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
# The fleet matrices' sweeps (8-host PHOLD, ev_cap 8: the retry sweep
# overflows; in the quarantine sweep lane 1 halts on its overflow).
SWEEP = """
general: {{seed: 5, stop_time: 40 ms}}
engine: {{scheduler: tpu, ev_cap: 8}}
network: {{single_vertex: {{latency: 1 ms}}}}
hosts:
  - {{name: h, count: 8}}
app:
  model: phold
  params: {{mean_delay_ns: 2000000.0, init_events: 6}}
sweep:
  seeds: [5, 6, 7]{vary}
"""
QUARANTINE_VARY = """
  vary:
    - {network: {single_vertex: {loss: 0.5}}}
    - {}
    - {network: {single_vertex: {loss: 0.5}}}"""


def chaos(*args, timeout=3000) -> tuple[int, dict]:
    r = subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch.tools.chaosprobe", *args,
         "--device", "cpu", "--json-only"], cwd=ROOT, env=ENV,
        capture_output=True, text=True, timeout=timeout)
    return r.returncode, json.loads(r.stdout.strip().splitlines()[-1])


def straight_stream(work: Path) -> dict:
    stream, conflict, _, _, _ = chaosprobe._collect_stream(
        chaosprobe._outputs(str(work / "ref.out")), False)
    assert conflict is None
    return {w: v for (_, w), v in stream.items()}


def test_solo_trials_bit_identical_and_equal_to_jax(tmp_path):
    jax_cli = subprocess.Popen(
        [sys.executable, "-m", "shadow1_tpu", PHOLD, "--windows",
         str(WINDOWS), "--heartbeat", str(CHUNK), "--state-digest", "on"],
        cwd=ROOT, env=ENV, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    rc, v = chaos(PHOLD, "--no-oracle", "--trials", "3", "--jobs", "3",
                  "--windows", str(WINDOWS), "--chunk", str(CHUNK), "--seed",
                  "1", "--work", str(tmp_path))
    _, err = jax_cli.communicate(timeout=600)
    assert jax_cli.returncode == 0, err[-2000:]
    assert rc == 0 and v["ok"], v
    assert v["trials"] == 3 and v["oracle_checked"] is False
    assert v["preempted_exits"] >= 1 and v["lineage_fallbacks"] >= 1
    assert sorted(v["kinds"]) == ["corrupt_head", "drain", "torn_head"]
    from shadow1_tpu.core.digest import DIGEST_FIELDS

    want = {r["window"]: tuple(r[f] for f in DIGEST_FIELDS)
            for r in map(json.loads, (s for s in err.splitlines()
                                      if s.startswith("{")))
            if r.get("type") == "ring"}
    got = straight_stream(tmp_path)
    assert len(got) == WINDOWS and got == want


def test_solo_needs_no_oracle_and_a_device(capsys):
    """A solo run needs a device: without one (and no card) it exits 1
    whether or not it would cross-check the oracle."""
    for extra in ([], ["--no-oracle"]):
        assert chaosprobe.main([PHOLD, *extra, "--trials", "1"]) == 1
        v = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert v["ok"] is False and "no CUDA device" in v["error"]


@pytest.mark.slow
def test_full_solo_matrix():
    rc, v = chaos(PHOLD, "--no-oracle", "--trials", "20", "--windows",
                  str(WINDOWS), "--chunk", str(CHUNK), "--seed", "0")
    assert rc == 0 and v["ok"] and v["trials"] == 20, v
    assert set(v["kinds"]) >= set(chaosprobe.SPECIAL_KINDS)


@pytest.mark.slow
def test_fleet_retry_matrix(tmp_path):
    cfg = tmp_path / "fr.yaml"
    cfg.write_text(SWEEP.format(vary=""))
    rc, v = chaos(str(cfg), "--fleet", "--extra", "--on-overflow retry",
                  "--trials", "3", "--windows", str(WINDOWS), "--chunk",
                  str(CHUNK), "--seed", "1")
    assert rc == 0 and v["ok"] and v["trials"] == 3 and v["fleet"], v


@pytest.mark.slow
def test_fleet_quarantine_matrix(tmp_path):
    cfg = tmp_path / "fq.yaml"
    cfg.write_text(SWEEP.format(vary=QUARANTINE_VARY))
    rc, v = chaos(str(cfg), "--fleet", "--extra",
                  "--on-overflow halt --on-lane-fail quarantine",
                  "--expect-quarantine", "1", "--trials", "1", "--windows",
                  str(WINDOWS), "--chunk", str(CHUNK), "--seed", "2")
    assert rc == 0 and v["ok"] and v["quarantined"] == [1], v


@pytest.mark.slow
def test_serve_kill_trials():
    rc, v = chaos(PHOLD, "--serve", "4", "--seed", "3", "--serve-kinds",
                  ",".join(chaosprobe.SERVE_KINDS))
    assert rc == 0 and v["ok"] and v["trials"] == 4, v
    assert v["torn_records"] == []
    assert [t["kind"] for t in v["verdicts"]] == list(chaosprobe.SERVE_KINDS)

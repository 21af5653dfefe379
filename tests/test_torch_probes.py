"""The port's probes (``shadow1_tpu_torch/tools/faultprobe.py``,
``memprobe.py``) against the JAX package's, on the CPU, and the port's
pointers at its own tools.

* faultprobe with ``--device cpu`` runs ``sort0``, ``scan0``, ``pop`` and
  ``phold``; its first line names the device; the ``pop`` probe's event
  buffer and popped event equal the JAX probe's ``push_local`` /
  ``pop_until`` on the same inputs. With no card and no ``--device cpu``
  it exits non-zero, and it refuses a device that is neither.
* memprobe: ``subbatch_run`` on the PHOLD sweep gives per-lane digest
  streams equal to the JAX ``memprobe.subbatch_parity``'s full fleet, and
  its verdict is ok; ``--audit`` passes on the CPU; ``--maxfit --budget``
  gives a well-formed envelope.
* The JSON mirrors ``chip_smoke.py`` phase 17 gives the tools on the card
  build the experiments of their YAML configs and of the goldens.
* No source of the port and no line of ``chip_smoke.py`` points at a
  ``shadow1_tpu.tools`` command, and nothing under
  ``shadow1_tpu_torch/tools/`` imports ``jax`` or ``shadow1_tpu``.

Tolerance: none (integers and bytes).
"""

from __future__ import annotations

import contextlib
import io
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from shadow1_tpu.core import events as events_j
from shadow1_tpu.tools import memprobe as memprobe_j
from shadow1_tpu_torch.tools import faultprobe, memprobe
from tests.test_torch_tgen import _one_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
SWEEP = str(ROOT / "configs" / "sweep_phold.yaml")
SWEEP_WINDOWS = 20


def run_main(main, argv) -> tuple[int, list]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(s) for s in buf.getvalue().splitlines()
                if s.startswith("{")]


def test_faultprobe_on_the_cpu():
    rc, lines = run_main(faultprobe.main,
                         ["sort0", "scan0", "pop", "phold", "--device", "cpu"])
    assert rc == 0, lines
    assert lines[0] == {"backend": "cpu", "device": "cpu", "name": "cpu"}
    assert [r["probe"] for r in lines[1:]] == ["sort0", "scan0", "pop",
                                               "phold"]
    assert all(r["ok"] for r in lines[1:])
    phold = lines[-1]
    assert phold["rounds"] > 0 and phold["ms_per_round"] > 0
    # The CPU runs the plain versions: no kernel launch.
    assert all(n == 0 for r in lines[1:] for n in r["launches"].values())


@pytest.mark.parametrize("argv", [["pop"], ["pop", "--device", "meta"]])
def test_faultprobe_refuses_without_a_card(argv):
    rc, lines = run_main(faultprobe.main, argv)
    assert rc == 1 and "error" in lines[0] and len(lines) == 1


def test_faultprobe_tor_probe_parses_its_count():
    assert faultprobe.parse_probes(["pop", "tor", "7", "phold", "tor"]) == [
        ("pop", 0), ("tor", 7), ("phold", 0), ("tor", 0)]


def test_pop_probe_matches_the_jax_probe():
    """The reference probe's cycle (``evbuf_init`` → ``push_local`` →
    ``pop_until``) on the same inputs."""
    buf, ev = faultprobe.pop_probe("cpu")
    _, mask, t, kind, p, until = faultprobe.pop_inputs("cpu")
    bj = events_j.evbuf_init(faultprobe.H, faultprobe.C)
    bj, _ = events_j.push_local(bj, jnp.asarray(mask.numpy()),
                                jnp.asarray(t.numpy()),
                                jnp.asarray(kind.numpy()),
                                jnp.asarray(p.numpy()))
    bj, evj = events_j.pop_until(bj, jnp.int64(int(until)))
    for name, got, want in ((f"buf.{k}", getattr(buf, k), getattr(bj, k))
                            for k in bj._fields):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    for k in evj._fields:
        np.testing.assert_array_equal(getattr(ev, k).numpy(),
                                      np.asarray(getattr(evj, k)),
                                      err_msg=f"popped.{k}")
    assert bool((ev.kind == 1).all()) and int(ev.kind.numel()) == faultprobe.H


@pytest.fixture(scope="module")
def jax_subbatch():
    """The JAX memprobe's verdict and its full fleet's lane streams (the
    first ``_lane_streams`` call of ``subbatch_parity``)."""
    seen = []
    orig = memprobe_j._lane_streams

    def keep(eng, st):
        seen.append(orig(eng, st))
        return seen[-1]

    memprobe_j._lane_streams = keep
    try:
        verdict = memprobe_j.subbatch_parity(SWEEP, None, SWEEP_WINDOWS,
                                             lambda *_: None)
    finally:
        memprobe_j._lane_streams = orig
    return verdict, seen[0]


def test_subbatch_streams_match_the_jax_memprobe(jax_subbatch):
    verdict_j, streams_j = jax_subbatch
    verdict, streams = memprobe.subbatch_run(SWEEP, None, SWEEP_WINDOWS,
                                             lambda *_: None, device="cpu")
    assert verdict["ok"] and verdict_j["ok"]
    assert streams == streams_j
    assert sorted(streams) == [0, 1, 2, 3]
    assert all(len(s) == SWEEP_WINDOWS for s in streams.values())
    common = ("experiments", "lanes_per_batch", "windows", "ckpt_cycled",
              "streams_compared")
    assert ({k: verdict[k] for k in common}
            == {k: verdict_j[k] for k in common})


def test_memprobe_audit_and_maxfit_on_the_cpu():
    rc, lines = run_main(memprobe.main, [
        SWEEP, str(ROOT / "configs" / "rung1_filexfer.yaml"), "--audit",
        "--maxfit", "--budget", str(64 << 20), "--device", "cpu",
        "--json-only"])
    assert rc == 0
    out = lines[-1]
    assert out["ok"] and out["device"] == "cpu"
    for row in out["audit"]:
        assert row["ok"] and row["measured_live"] > 0
        assert abs(row["ratio"] - 1) <= 0.10
    sweep, rung1 = out["maxfit"]
    assert sweep["budget"] == 64 << 20 and out["budget_source"] == "--budget"
    assert sweep["max_hosts"] > sweep["hosts"] == 64
    assert sweep["sweep_lanes"] == 4 and sweep["max_lanes"] == 4
    assert sweep["max_lanes_linear"] >= 4 and sweep["lane_bytes"] > 0
    assert rung1["max_hosts"] > 2 and "max_lanes" not in rung1


def test_memprobe_fleet_audit_and_errors():
    rc, lines = run_main(memprobe.main, [SWEEP, "--audit", "--fleet",
                                         "--device", "cpu", "--json-only"])
    assert rc == 0 and lines[-1]["audit"][0]["n_exp"] == 4
    assert lines[-1]["audit"][0]["ok"]
    rc, lines = run_main(memprobe.main, [SWEEP, "--maxfit", "--device",
                                         "cpu", "--json-only"])
    assert rc == 2 and lines[-1] == {"ok": False, "error": "no_budget"}
    rc, lines = run_main(memprobe.main, [SWEEP, "--json-only"])
    assert rc == 2 and lines[-1]["error"] == "no_device"


# -- the card's configs ------------------------------------------------------

def _arrays_sha(exp) -> str:
    import hashlib

    from shadow1_tpu_torch.config import compiled as ct

    return hashlib.sha256(json.dumps(ct.experiment_arrays(exp),
                                     sort_keys=True).encode()).hexdigest()


@pytest.mark.parametrize("name,yaml_name", [
    ("tor1k", "rung3_tor1k"), ("rung1", "rung1_filexfer"),
    ("dense_tgen50k", "dense_tgen50k"), ("serve_phold", "serve_phold")])
def test_card_mirrors_build_the_yaml_experiments(tmp_path, monkeypatch,
                                                name, yaml_name):
    """``chip_smoke.py`` phase 17 runs the tools on JSON mirrors of the
    YAML configs (the card has no YAML parser): each builds the experiment
    and params its YAML builds; rung1's also the golden's."""
    import chip_smoke
    from shadow1_tpu_torch.config.experiment import load_experiment

    monkeypatch.setattr(chip_smoke, "TOOLS_DIR", tmp_path)
    paths = chip_smoke.tool_configs()
    got = load_experiment(paths[name])
    want = load_experiment(str(ROOT / "configs" / f"{yaml_name}.yaml"))
    assert _arrays_sha(got[0]) == _arrays_sha(want[0])
    assert got[1:] == want[1:]
    if name == "rung1":
        gold = json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                           / "net_rung1.json").read_text())
        assert _arrays_sha(got[0]) == gold["experiment_sha256"]


def test_card_sweep_mirror_is_the_fleet_golden(tmp_path, monkeypatch):
    """The 17-lane JSON sweep is ``sweep_phold_experiments`` (the lanes of
    ``golden/fleet_sweep_phold.json``), lane by lane; its under-sized
    twin differs in ``ev_cap`` only."""
    import dataclasses

    import chip_smoke
    from shadow1_tpu_torch.config.compiled import sweep_phold_experiments
    from shadow1_tpu_torch.fleet.expand import load_sweep

    monkeypatch.setattr(chip_smoke, "TOOLS_DIR", tmp_path)
    paths = chip_smoke.tool_configs()
    exps, params, max_rounds, _ = sweep_phold_experiments()
    plan = load_sweep(paths["sweep17"])
    assert [_arrays_sha(e) for e in plan.exps] == [_arrays_sha(e)
                                                  for e in exps]
    assert plan.params == params and plan.max_rounds == max_rounds
    small = load_sweep(paths["sweep17_small"])
    assert small.params == dataclasses.replace(
        params, ev_cap=chip_smoke.CHAOS_FLEET_CAP)


# -- the pointers -------------------------------------------------------------

def _sources():
    files = sorted((ROOT / "shadow1_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_no_pointer_at_the_reference_tools():
    bad = [f"{f.relative_to(ROOT)}:{i}" for f in _sources()
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if re.search(r"shadow1_tpu\.tools", line)]
    assert not bad, bad


def test_port_tools_import_neither_jax_nor_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|shadow1_tpu)\b(?!_torch)")
    bad = [f"{f.relative_to(ROOT)}:{i}"
           for f in sorted((ROOT / "shadow1_tpu_torch" / "tools").glob("*.py"))
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.search(line)]
    assert not bad, bad

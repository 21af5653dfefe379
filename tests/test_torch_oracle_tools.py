"""The tools that stand on the port's oracle, against the JAX package's.

* ``pcapdump``: the ``.pcap`` bytes of rung 1 (every packet, one
  ``--host``, one ``--edge``) equal the reference's;
* ``activeprobe`` and ``depthprobe`` on rung 3 Tor, and ``occprobe`` on a
  small PHOLD (the port's ``Engine`` with ``--device cpu``): their JSON
  rows equal the reference's; ``occprobe`` without a card and without
  ``--device`` exits non-zero rather than run on the CPU;
* the CLI's ``--engine cpu``: its result line (but for wall-clock rates
  and the port's ``device`` and ``summary`` keys) and its stderr rows
  (digest, work, flow and link) equal the reference CLI's; it refuses
  ``--device cuda`` and the batched engine's chunked-run flags;
* chaosprobe's solo cross-check: a solo run without ``--no-oracle`` runs
  the oracle on the same windows and reports ``"oracle_checked": true``.

Bit-exact throughout (byte-exact for the pcap files).
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RUNG1 = str(ROOT / "configs" / "rung1_filexfer.yaml")
TOR1K = str(ROOT / "configs" / "rung3_tor1k.yaml")
PHOLD = str(ROOT / "configs" / "serve_phold.yaml")


def _main(module, argv) -> tuple[int, str, str]:
    """Run ``module.main(argv)`` in process: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            rc = module.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _ref_main(module, argv, monkeypatch) -> tuple[int, str, str]:
    """The reference tools whose ``main()`` reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [module.__name__] + list(argv))
    return _main(type("M", (), {"main": staticmethod(
        lambda _argv: module.main())}), None)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    (), ("--host", "server"), ("--host", "client", "--sock", "0"),
    ("--edge", "pop_west:pop_east")], ids=["all", "host", "sock", "edge"])
def test_pcapdump_bytes_match_jax(tmp_path, flags):
    from shadow1_tpu.tools import pcapdump as pj
    from shadow1_tpu_torch.tools import pcapdump as pt

    args = ("--windows", "30", *flags)
    rc, out, _ = _main(pt, [RUNG1, str(tmp_path / "t.pcap"), *args])
    assert rc == 0 and "packets captured" in out
    assert _main(pj, [RUNG1, str(tmp_path / "j.pcap"), *args])[0] == 0
    got = (tmp_path / "t.pcap").read_bytes()
    assert got == (tmp_path / "j.pcap").read_bytes()
    assert len(got) > 24 + 16  # the header and at least one packet


@pytest.mark.parametrize("tool", ["activeprobe", "depthprobe"])
def test_probe_rows_match_jax(monkeypatch, tool):
    import importlib

    mt = importlib.import_module(f"shadow1_tpu_torch.tools.{tool}")
    mj = importlib.import_module(f"shadow1_tpu.tools.{tool}")
    argv = [TOR1K, "--windows", "25"]
    rc, out, _ = _main(mt, argv)
    assert rc == 0
    rc_j, out_j, _ = _ref_main(mj, argv, monkeypatch)
    assert rc_j == 0
    row = _last_json(out)
    assert row == _last_json(out_j) and row["events"] > 0


def test_occprobe_row_matches_jax(monkeypatch):
    from shadow1_tpu.tools import occprobe as oj
    from shadow1_tpu_torch.tools import occprobe as ot

    argv = ["--windows", "20", "--step", "5", PHOLD]
    rc, out, _ = _main(ot, argv + ["--device", "cpu"])
    rc_j, out_j, _ = _ref_main(oj, argv, monkeypatch)
    assert rc == rc_j == 0
    row = _last_json(out)
    assert row == _last_json(out_j) and row["boundary_peak_occupancy"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ot.main(argv)


_RATES = ("wall_seconds", "sim_per_wall", "events_per_sec")


@pytest.mark.parametrize("flags", [
    (), ("--watch", "client:0", "--watch", "server", "--link-telem", "on",
         "--selfcheck", "--on-overflow", "halt")], ids=["plain", "planes"])
def test_cli_engine_cpu_matches_jax(flags):
    from shadow1_tpu_torch import cli

    argv = [RUNG1, "--engine", "cpu", "--windows", "40", "--state-digest",
            "on", *flags]
    rc, out, err = _main(cli, argv)
    ref = subprocess.run([sys.executable, "-m", "shadow1_tpu", *argv],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert rc == 0 and ref.returncode == 0, ref.stderr[-2000:]
    got, want = _last_json(out), _last_json(ref.stdout)
    assert got.pop("device") == "cpu" and got.pop("summary")
    for k in _RATES:
        got.pop(k), want.pop(k)
    assert got == want and got["engine"] == "cpu"

    def rows(text):
        return [s for s in text.splitlines() if s.startswith('{"type"')]

    assert rows(err) == rows(ref.stderr)
    kinds = {json.loads(s)["type"] for s in rows(err)}
    assert "digest" in kinds and (not flags or {"flow", "link"} <= kinds)


@pytest.mark.parametrize("flags,msg", [
    (("--device", "cuda"), "contradicts"),
    (("--heartbeat", "5"), "require a batched engine"),
    (("--on-overflow", "retry"), "require a batched engine"),
    (("--ckpt", "x.npz"), "require a batched engine"),
])
def test_cli_engine_cpu_refusals(capsys, flags, msg):
    from shadow1_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main([RUNG1, "--engine", "cpu", *flags])
    assert e.value.code == 2 and msg in capsys.readouterr().err


def test_chaosprobe_solo_cross_checks_the_oracle(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch.tools.chaosprobe", PHOLD,
         "--device", "cpu", "--trials", "0", "--windows", "10", "--chunk",
         "5", "--seed", "1", "--work", str(tmp_path), "--json-only"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    v = _last_json(r.stdout)
    assert r.returncode == 0 and v["ok"] and v["oracle_checked"] is True, v
    orc = [json.loads(s) for s in (tmp_path / "oracle.stderr").read_text()
           .splitlines() if s.startswith('{"type": "digest"')]
    assert len(orc) == 10 and v["digest_rows"] == 10


def _arrays_sha(exp) -> str:
    import hashlib

    from shadow1_tpu_torch.config import compiled as ct

    return hashlib.sha256(json.dumps(ct.experiment_arrays(exp),
                                     sort_keys=True).encode()).hexdigest()


@pytest.mark.parametrize("name,yaml_name", [
    ("tor10k", "rung4_tor10k"), ("rung1", "rung1_filexfer"),
    ("dense_tgen50k", "dense_tgen50k")])
def test_phase18_mirrors_build_the_yaml_experiments(tmp_path, name,
                                                    yaml_name):
    """``chip_smoke.py`` phase 18 (and the golden writer) run the tools on
    JSON mirrors of the YAML configs: each builds the experiment and
    params its YAML builds."""
    import chip_smoke
    from shadow1_tpu_torch.config.experiment import load_experiment

    paths = chip_smoke.oracle_configs(tmp_path)
    got = load_experiment(paths[name])
    want = load_experiment(str(ROOT / "configs" / f"{yaml_name}.yaml"))
    assert _arrays_sha(got[0]) == _arrays_sha(want[0])
    assert got[1:] == want[1:]


def test_phase18_sweep_mirror_is_the_yaml_sweep(tmp_path):
    """The 4-lane JSON sweep is configs/sweep_phold.yaml lane by lane (the
    YAML spells the mean delay ``2.0e7``, which its loader keeps as text
    and PHOLD reads as a float); its under-sized twin differs in
    ``ev_cap`` only."""
    import dataclasses

    import chip_smoke
    from shadow1_tpu_torch.fleet.expand import load_sweep

    paths = chip_smoke.oracle_configs(tmp_path)
    got, want = load_sweep(paths["sweep_phold"]), load_sweep(
        str(ROOT / "configs" / "sweep_phold.yaml"))
    for a, b in zip(got.exps, want.exps, strict=True):
        b.model_cfg = dict(b.model_cfg,
                           mean_delay_ns=float(b.model_cfg["mean_delay_ns"]))
        assert _arrays_sha(a) == _arrays_sha(b)
    assert got.params == want.params and got.max_rounds == want.max_rounds
    small = load_sweep(paths["sweep_phold_small"])
    assert small.params == dataclasses.replace(
        want.params, ev_cap=chip_smoke.CHAOS_FLEET_CAP)

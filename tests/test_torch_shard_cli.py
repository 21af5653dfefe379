"""``--engine sharded`` in the CLI under ``torchrun`` (2 gloo CPU ranks):
the result line equals the JAX CLI's ``--engine sharded`` over 2 CPU
devices; a snapshot that the JAX sharded CLI writes resumes in the port;
a ``--ckpt`` run resumed from its lineage equals the straight run.

``torchrun --standalone`` picks a free rendezvous port, so these runs can
go side by side with other test workers."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CFG = str(ROOT / "configs" / "rung1_filexfer.yaml")
# Fields of a result line that depend on the wall clock or the device.
TIMED = ("wall_seconds", "sim_per_wall", "events_per_sec", "device")


def _env(**kw):
    env = {**os.environ, "OMP_NUM_THREADS": "1", **kw}
    return env


def torchrun(*args, timeout=240) -> dict:
    """``torchrun --standalone --nproc-per-node 2 -m shadow1_tpu_torch``
    on the CPU: the result line."""
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "shadow1_tpu_torch", CFG,
         "--device", "cpu", "--engine", "sharded", *args],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [s for s in r.stdout.splitlines() if s.startswith("{")]
    return json.loads(lines[-1])


def _bare(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in TIMED}


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's --engine sharded over 2 CPU devices, 10 windows, with
    its snapshot."""
    snap = tmp_path_factory.mktemp("jax") / "j.npz"
    flags = os.environ.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", "")
    r = subprocess.run(
        [sys.executable, "-m", "shadow1_tpu", CFG, "--engine", "sharded",
         "--windows", "10", "--summary", "--save-state", str(snap)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=flags
                 + " --xla_force_host_platform_device_count=2"))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), snap


@pytest.fixture(scope="module")
def straight():
    return torchrun("--windows", "20")


def test_result_line_equals_the_jax_cli(jax_cli):
    ref, _ = jax_cli
    got = torchrun("--windows", "10")
    assert got["engine"] == ref["engine"] == "sharded"
    assert _bare(got) == _bare(ref), (
        {k: (ref.get(k), got.get(k)) for k in set(got) | set(ref)
         if k not in TIMED and got.get(k) != ref.get(k)})


def test_jax_sharded_snapshot_resumes_in_the_port(jax_cli, straight):
    """The JAX sharded CLI's window-10 snapshot (the gathered global state)
    resumes on 2 port ranks and ends where a straight port run ends."""
    _, snap = jax_cli
    got = torchrun("--resume", str(snap), "--windows", "10")
    assert got["resumed"] and got["metrics"] == straight["metrics"]
    assert got["summary"] == straight["summary"]


def test_ckpt_resume_equals_the_straight_run(tmp_path, straight):
    """A 2-rank run under --ckpt stops at window 10 (rank 0 writes the
    gathered state); the same command with --windows 20 resumes from the
    lineage and ends equal to the straight run."""
    ck = str(tmp_path / "c.npz")
    first = torchrun("--ckpt", ck, "--windows", "10", "--heartbeat", "5")
    assert first["metrics"]["windows"] == 10 and Path(ck).exists()
    got = torchrun("--ckpt", ck, "--windows", "20", "--heartbeat", "5")
    assert got["resumed"] and got["metrics"] == straight["metrics"]
    assert got["summary"] == straight["summary"]


@pytest.mark.parametrize("flags,says", [
    (["--engine", "sharded", "--dist-backend", "nccl"], "gloo"),
    (["--dist-backend", "gloo"], "needs --engine sharded"),
])
def test_backend_refusals(flags, says, capsys):
    """NCCL on CPU ranks is refused, naming gloo (nothing is redirected);
    --dist-backend is a sharded run's flag."""
    from shadow1_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main([CFG, "--device", "cpu", *flags])
    assert e.value.code == 2 and says in capsys.readouterr().err

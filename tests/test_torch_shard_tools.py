"""paritytrace on the sharded engine (2 gloo CPU ranks): the digest
streams of ``tpu`` and ``sharded:2`` are identical on rung1, an injected
corruption of each subsystem is named at its window, and the verdict
equals the JAX package's paritytrace on the same config and sides."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from shadow1_tpu_torch.tools import paritytrace as pt_t

ROOT = Path(__file__).resolve().parents[1]
CFG = str(ROOT / "configs" / "rung1_filexfer.yaml")
ARGS = (CFG, "tpu", "sharded:2", "--windows", "12", "--chunk", "6")


def run(module, *argv) -> tuple[int, dict]:
    """``module.main(argv)`` in process: (exit code, the verdict line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = module.main(list(argv))
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_verdict_equals_the_reference():
    """``--inject 5:rng`` on the sharded side: exit 3, (5, rng) named —
    the reference's verdict over the same sides."""
    argv = (*ARGS, "--inject", "5:rng", "--no-localize")
    # The JAX paritytrace runs in a process of its own meanwhile.
    ref = subprocess.Popen(
        [sys.executable, "-m", "shadow1_tpu.tools.paritytrace", *argv],
        cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        rc, got = run(pt_t, *argv, "--device", "cpu")
        out, _ = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert (rc, got) == (ref.returncode,
                         json.loads(out.strip().splitlines()[-1]))
    assert rc == 3 and got["first_divergence"] == {
        "window": 5, "subsystems": ["rng"]}


def test_identical_streams_and_the_plane_dump(tmp_path):
    """``tpu sharded:2`` streams are identical (exit 0); an injection is
    localized to host 0's self_ctr by the rerun's plane dump."""
    rc, got = run(pt_t, *ARGS, "--device", "cpu")
    assert rc == 0 and got["first_divergence"] is None
    assert got["windows_compared"] == 12
    dump = tmp_path / "d.jsonl"
    rc, got = run(pt_t, *ARGS, "--device", "cpu", "--inject", "5:rng",
                  "--dump", str(dump))
    assert rc == 3 and got["diff_records"] == 1
    recs = [json.loads(s) for s in dump.read_text().splitlines()]
    assert recs[-1] == {"type": "plane_diff", "subsystem": "rng",
                        "field": "self_ctr", "host": 0, "a": 1, "b": 2}


@pytest.mark.parametrize("subsys", ["evbuf", "nic", "tcp"])
def test_injection_names_its_subsystem(subsys):
    rc, got = run(pt_t, *ARGS, "--device", "cpu", "--no-localize",
                  "--inject", f"4:{subsys}")
    assert rc == 3
    assert got["first_divergence"] == {"window": 4, "subsystems": [subsys]}


def test_usage_errors_exit_2():
    with pytest.raises(SystemExit) as e:
        pt_t.main([CFG, "tpu", "gpu:2", "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        pt_t.main([CFG, "tpu", "cpu+resume", "--device", "cpu"])
    assert e.value.code == 2


def test_pallas_and_resume_modifiers():
    """``+pallas`` is accepted and changes nothing (the device picks the
    kernel path); ``+resume`` round-trips a snapshot at every boundary of
    the sharded side (rank 0 writes the gathered state)."""
    rc, got = run(pt_t, CFG, "tpu+pallas", "sharded:2+resume", "--windows",
                  "8", "--chunk", "4", "--device", "cpu")
    assert rc == 0 and got["first_divergence"] is None

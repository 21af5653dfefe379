"""The port's checkpoint lineage against the JAX package's, on the CPU.

The same files (the head at the bare path, older generations at
``<path>.gNNNNNN``, the manifest at ``<path>.lineage``) and the same
manifest schema, so each package's ``Lineage.resolve`` accepts the other's
lineage and loads its snapshots. Rotation prunes to ``keep``; a corrupt
head falls back one generation; the reference's injection hooks
(``SHADOW1_LINEAGE_CRASH_BETWEEN`` / ``_TORN_HEAD``) kill a saving process
at the instants they name, and the lineage left behind still resolves.
States: a small PHOLD under host churn with the ring, the digest words
and a host probe on.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from shadow1_tpu import lineage as lineage_j
from shadow1_tpu.ckpt import load_state as load_j
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import lineage as lineage_t
from shadow1_tpu_torch.ckpt import load_state as load_t
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from tests.test_torch_fault import _phold_churn_exp
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import _one_thread, assert_same_leaves  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PARAMS = dict(metrics_ring=8, state_digest=1, probes=((1, -1),))


@pytest.fixture(scope="module")
def engines():
    eng_t = EngineT(_phold_churn_exp(), EngineParamsT(**PARAMS), device="cpu")
    eng_j = EngineJ(jax_experiment(_phold_churn_exp()),
                    EngineParamsJ(**PARAMS))
    return eng_t, eng_j


@pytest.fixture(scope="module")
def states(engines):
    """Port states after 0, 2, 4 and 6 windows."""
    eng_t, _ = engines
    out, st = [], eng_t.init_state()
    for _ in range(4):
        out.append(convert.state_to_numpy(st))
        st = eng_t.run(st, n_windows=2)
    return out


def _port_state(states, i):
    return convert.state_from_numpy(states[i], "cpu")


def _save_all(lin, states, to_state):
    for i in range(len(states)):
        lin.save(to_state(i), {"win_start": 2 * i, "done_windows": 2 * i})


def test_rotation_prunes_to_keep(tmp_path, states):
    path = str(tmp_path / "c.npz")
    lin = lineage_t.Lineage(path, keep=2)
    _save_all(lin, states, lambda i: _port_state(states, i))
    names = sorted(os.listdir(tmp_path))
    assert names == ["c.npz", "c.npz.g000002", "c.npz.lineage"]
    man = json.loads(Path(path + ".lineage").read_text())
    assert man["keep"] == 2 and man["head_seq"] == 3
    assert [e["seq"] for e in man["generations"]] == [2, 3]
    assert [e["done_windows"] for e in lin.generations()] == [4, 6]
    r = lin.resolve()
    assert (r.path, r.seq, r.skipped) == (path, 3, [])
    lin.remove_all()
    assert os.listdir(tmp_path) == []


def test_corrupt_head_falls_back_one_generation(tmp_path, states, engines):
    eng_t, _ = engines
    path = str(tmp_path / "c.npz")
    lin = lineage_t.Lineage(path, keep=3)
    _save_all(lin, states, lambda i: _port_state(states, i))
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    r = lin.resolve()
    assert r.seq == 2 and r.path == path + ".g000002"
    assert [s["file"] for s in r.skipped] == [path]
    st = load_t(eng_t.init_state(), r.path)
    assert_same_leaves(states[2], convert.state_to_numpy(st))
    assert lineage_j.Lineage(path, keep=3).resolve() == r
    lin.resolve(discard_invalid=True)
    assert not os.path.exists(path)
    # Every generation corrupt: the walk names them all.
    for _, f in lin._scan_gens():
        Path(f).write_bytes(b"not a zip")
    r = lin.resolve()
    assert r.path is None and len(r.skipped) == 2


def test_each_package_resolves_the_others_lineage(tmp_path, states, engines):
    eng_t, eng_j = engines
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    _save_all(lineage_t.Lineage(pt, keep=2), states,
              lambda i: _port_state(states, i))
    _save_all(lineage_j.Lineage(pj, keep=2), states,
              lambda i: jax.tree.map(np.asarray, states[i]))
    # The JAX package reads the port's lineage.
    r = lineage_j.Lineage(pt, keep=2).resolve()
    assert r.path == pt and r.meta["done_windows"] == 6
    st = load_j(eng_j.init_state(), r.path)
    assert_same_leaves(jax.tree.map(np.asarray, st), states[3])
    # The port reads the JAX package's.
    r = lineage_t.Lineage(pj, keep=2).resolve()
    assert r.path == pj and r.meta["done_windows"] == 6
    st = load_t(eng_t.init_state(), r.path)
    assert_same_leaves(states[3], convert.state_to_numpy(st))
    # The same saves make the same manifest, key for key.
    mt = json.loads(Path(pt + ".lineage").read_text())
    mj = json.loads(Path(pj + ".lineage").read_text())
    assert mt == mj
    assert ([sorted(e) for e in mt["generations"]]
            == [sorted(e) for e in mj["generations"]])


_CHILD = """
import os
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from shadow1_tpu_torch.consts import EngineParams
from shadow1_tpu_torch.core.engine import Engine
from shadow1_tpu_torch.lineage import Lineage
from tests.test_torch_fault import _phold_churn_exp

eng = Engine(_phold_churn_exp(), EngineParams(**{params!r}), device="cpu")
st = eng.init_state()
lin = Lineage({path!r}, keep=3)
for i in range(3):
    lin.save(st, {{"win_start": i, "done_windows": i}})
    # Armed after the first save: the hook fires in the second.
    os.environ[{var!r}] = {flag!r}
    st = eng.run(st, n_windows=1)
"""


@pytest.mark.parametrize("hook", ["CRASH_BETWEEN", "TORN_HEAD"])
def test_injection_hooks_leave_a_resolvable_lineage(tmp_path, hook):
    """The hook, armed after a first save, kills the second save's process
    (137): between rotating the head away and installing the new one (no
    head on disk), or with the new head installed and torn. Either way the
    lineage resolves to the first save's generation. The hook's flag file
    makes it fire once: run again, every save goes through."""
    path = str(tmp_path / "c.npz")
    code = _CHILD.format(root=str(ROOT), params=PARAMS, path=path,
                         var=f"SHADOW1_LINEAGE_{hook}",
                         flag=str(tmp_path / "flag"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}

    def child():
        return subprocess.run([sys.executable, "-c", code], env=env,
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=120)

    first = child()
    assert first.returncode == 137, first.stderr
    for pkg in (lineage_t, lineage_j):
        r = pkg.Lineage(path, keep=3).resolve()
        assert r.path == path + ".g000000" and r.meta["done_windows"] == 0
        assert [s["file"] for s in r.skipped] == (
            [path] if hook == "TORN_HEAD" else [])
    again = child()
    assert again.returncode == 0, again.stderr
    r = lineage_t.Lineage(path, keep=3).resolve()
    assert r.path == path and r.meta["done_windows"] == 2 and not r.skipped
    assert r == lineage_j.Lineage(path, keep=3).resolve()


def _supervised(tmp_path, env):
    """``python -m shadow1_tpu_torch churn_filexfer.yaml --ckpt`` for 6
    windows with a snapshot at every 2-window heartbeat."""
    cfg = str(ROOT / "configs" / "churn_filexfer.yaml")
    return subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch", cfg, "--device", "cpu",
         "--windows", "6", "--heartbeat", "2", "--ckpt-every-s", "0",
         "--ckpt", str(tmp_path / "c.npz")], cwd=ROOT, timeout=300,
        capture_output=True, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "SHADOW1_SUPERVISE_BACKOFF_S": "0", **env})


def test_supervisor_discards_a_lineage_with_no_valid_generation(tmp_path):
    """The first child tears its first snapshot and dies: no generation
    verifies, so the supervisor discards the lineage and starts over; the
    next child dies right after its window-4 snapshot and the third resumes
    from it. The run ends as a straight one does."""
    out = _supervised(tmp_path, {
        "SHADOW1_LINEAGE_TORN_HEAD": str(tmp_path / "flag"),
        "SHADOW1_OBS_CRASH_AT_NS": str(4 * 40_000_000)})
    assert out.returncode == 0, out.stderr[-3000:]
    events = [json.loads(s) for s in out.stderr.splitlines()
              if s.startswith('{"type": ')]
    assert [e["event"] for e in events if e["type"] == "lineage"] == [
        "discard_all"]
    assert [e["win_start"] for e in events if e["type"] == "resume"] == [
        4 * 40_000_000]
    from shadow1_tpu_torch.config.experiment import load_experiment

    exp, params, _ = load_experiment(str(ROOT / "configs"
                                         / "churn_filexfer.yaml"))
    straight = EngineT(exp, params, device="cpu").run(n_windows=6)
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["resumed"]
    assert result["metrics"] == EngineT.metrics_dict(straight)


def test_supervisor_gives_up_after_two_crashes_without_progress(tmp_path):
    """A child that dies before its first snapshot, twice: the fault is
    deterministic there, and the supervisor exits with the child's code
    instead of respawning again."""
    out = _supervised(tmp_path, {
        "SHADOW1_OBS_CRASH_PRE_SAVE_AT_NS": str(2 * 40_000_000)})
    assert out.returncode == 41
    assert out.stderr.count("respawning") == 1
    assert "two consecutive crashes (rc=41)" in out.stderr

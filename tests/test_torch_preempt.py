"""The port's preemption plane (``shadow1_tpu_torch/preempt.py``) and the
``--ckpt`` supervisor's watchdog, against the JAX package, on the CPU.

* the exit-code taxonomy, the grace window and ``PreemptedExit`` equal
  the reference's;
* ``run_chunked`` with a drain latched inside ``on_chunk`` stops one
  boundary later with ``PreemptedExit``, carrying the state of exactly
  the committed windows — the JAX runner's, leaf by leaf; a latch on the
  final chunk is a normal exit;
* the injection hooks: SIGTERM-self latches an installed
  ``DrainHandler`` and ``run_with_heartbeat`` forces the snapshot before
  the drain; a hang whose once-flag exists passes; crash-pre-save exits
  41;
* the CLI on ``configs/rung1_filexfer.yaml`` (no compile step on the
  port's CPU path): SIGTERM mid-run exits ``EXIT_PREEMPTED`` with the
  reference's record, the supervisor keeps the checkpoint, and rerunning
  the command resumes to a final ``.npz`` equal to an uninterrupted
  run's; a child whose progress sidecar stops (the hang hook) is killed
  by the watchdog, respawned, and finishes equal; two hangs without
  progress exit ``EXIT_HUNG`` (``slow``).
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from shadow1_tpu import consts as consts_j
from shadow1_tpu import preempt as preempt_j
from shadow1_tpu.ckpt import run_chunked as run_chunked_j
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu_torch import consts as consts_t
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import preempt as preempt_t
from shadow1_tpu_torch.ckpt import run_chunked as run_chunked_t
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.lineage import Lineage
from shadow1_tpu_torch.obs import run_with_heartbeat
from tests.test_torch_tgen import _one_thread, assert_same_leaves  # noqa: F401
from tests.test_torch_tune import both, phold_kw

ROOT = Path(__file__).resolve().parents[1]
RUNG1 = str(ROOT / "configs" / "rung1_filexfer.yaml")
WINDOW_NS = 40_000_000  # rung1's window
# The CLI runs: 12 windows in chunks of 3; the hooks fire at window 6.
WINDOWS, CHUNK, AT = 12, 3, 6
# The watchdog's deadline: above a 3-window chunk of rung1 and, times 3,
# above a child's start-up, with six test processes sharing the cores.
WATCHDOG_S = 8
MS_1 = 10**6  # phold_kw's 1 ms windows
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "SHADOW1_SUPERVISE_BACKOFF_S": "0"}


def test_exit_codes_and_preempted_exit_match_reference():
    for name in ("EXIT_OK", "EXIT_CONFIG", "EXIT_CAPACITY", "EXIT_PREEMPTED",
                 "EXIT_HUNG", "EXIT_MEMORY"):
        assert getattr(consts_t, name) == getattr(consts_j, name), name
    assert consts_t.EXIT_CODES == consts_j.EXIT_CODES
    assert preempt_t.FORCE_GRACE_S == preempt_j.FORCE_GRACE_S
    kw = dict(signame="SIGINT", done_windows=30, win_start=7, ckpt="c.npz",
              generation=2)
    assert str(preempt_t.PreemptedExit(**kw)) == str(
        preempt_j.PreemptedExit(**kw))
    assert str(preempt_t.PreemptedExit()) == str(preempt_j.PreemptedExit())


def _drained(pkg, exp, latch_at: int, windows: int):
    """run_chunked in chunks of 10 with the drain latched inside on_chunk
    at ``latch_at``: the PreemptedExit, or the final state."""
    if pkg == "jax":
        eng = EngineJ(exp, EngineParamsJ(ev_cap=32))
        run, drain = run_chunked_j, preempt_j.DrainHandler()
    else:
        eng = EngineT(exp, EngineParamsT(ev_cap=32), device="cpu")
        run, drain = run_chunked_t, preempt_t.DrainHandler()

    def on_chunk(st, done):
        if done == latch_at:
            drain.signame = "SIGTERM"  # latched mid-on_chunk, not installed

    return run(eng, n_windows=windows, chunk=10, on_chunk=on_chunk,
               drain=drain), eng


def test_drain_commits_the_inflight_chunk_like_reference():
    exp_j, exp_t = both(phold_kw(n_hosts=8))
    caught = []
    for pkg, exp in (("jax", exp_j), ("torch", exp_t)):
        mod = preempt_j if pkg == "jax" else preempt_t
        with pytest.raises(mod.PreemptedExit) as ei:
            _drained(pkg, exp, 20, 50)
        caught.append(ei.value)
    ej, et = caught
    assert (et.done_windows, et.win_start, et.signame) == (
        ej.done_windows, ej.win_start, ej.signame) == (30, 30 * MS_1, "SIGTERM")
    assert_same_leaves(jax.tree.map(np.asarray, ej.st),
                       convert.state_to_numpy(et.st))
    eng = EngineT(exp_t, EngineParamsT(ev_cap=32), device="cpu")
    assert_same_leaves(convert.state_to_numpy(eng.run(n_windows=30)),
                       convert.state_to_numpy(et.st))
    # A latch on the final chunk: nothing left to preempt.
    st, _ = _drained("torch", exp_t, 30, 30)
    assert int(st.metrics.windows) == 30


def test_injection_hooks(tmp_path, monkeypatch):
    """SIGTERM-self latches the installed handler: run_with_heartbeat
    forces the snapshot at the next boundary and the runner raises there;
    a hang whose once-flag exists passes; crash-pre-save exits 41."""
    _, exp = both(phold_kw(n_hosts=8))
    eng = EngineT(exp, EngineParamsT(ev_cap=32), device="cpu")
    path = str(tmp_path / "ck.npz")
    flag = tmp_path / "hung.flag"
    flag.write_text("hung")
    monkeypatch.setenv("SHADOW1_OBS_SIGTERM_SELF_AT_NS", str(20 * MS_1))
    monkeypatch.setenv("SHADOW1_OBS_HANG_AT_NS", str(10 * MS_1))
    monkeypatch.setenv("SHADOW1_OBS_HANG_ONCE_FLAG", str(flag))
    drain = preempt_t.DrainHandler().install()
    try:
        with pytest.raises(preempt_t.PreemptedExit) as ei:
            run_with_heartbeat(eng, n_windows=50, every_windows=10,
                               stream=False, ckpt_path=path,
                               ckpt_every_s=1e9, drain=drain)
    finally:
        drain.uninstall()
    assert ei.value.done_windows == 30 and drain.signame == "SIGTERM"
    res = Lineage(path).resolve()
    assert res.meta["done_windows"] == 30
    with open(path + ".progress") as f:
        assert json.load(f)["win_start"] == 30 * MS_1
    crash = subprocess.run(
        [sys.executable, "-c", "from shadow1_tpu_torch.preempt import "
         "run_injection_hooks as h; h(5); h(7)"], cwd=ROOT,
        env={**ENV, "SHADOW1_OBS_CRASH_PRE_SAVE_AT_NS": "7"}, timeout=120)
    assert crash.returncode == 41


def _port(*args, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch", RUNG1, "--device", "cpu",
         "--windows", str(WINDOWS), "--heartbeat", str(CHUNK),
         "--ckpt-every-s", "0", *args], cwd=ROOT, env={**ENV, **(env or {})},
        capture_output=True, text=True, timeout=timeout)


def _same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """An uninterrupted run's final snapshot."""
    path = str(tmp_path_factory.mktemp("straight") / "ref.npz")
    r = _port("--save-state", path)
    assert r.returncode == 0, r.stderr[-800:]
    return path


def test_cli_sigterm_drain_then_resume(tmp_path, straight):
    ck, fin = str(tmp_path / "ck.npz"), str(tmp_path / "fin.npz")
    r = _port("--ckpt", ck,
              env={"SHADOW1_OBS_SIGTERM_SELF_AT_NS": str(AT * WINDOW_NS)})
    assert r.returncode == consts_t.EXIT_PREEMPTED, (r.returncode,
                                                     r.stderr[-800:])
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec == {"preempted": True, "signal": "SIGTERM",
                   "windows_done": AT + CHUNK,
                   "win_start": (AT + CHUNK) * WINDOW_NS, "ckpt": ck,
                   "resumed": False}
    assert "child drained" in r.stderr and "respawning" not in r.stderr
    assert os.path.exists(ck)
    r = _port("--ckpt", ck, "--save-state", fin)
    assert r.returncode == 0, r.stderr[-800:]
    resumes = [json.loads(x) for x in r.stderr.splitlines()
               if x.startswith("{") and '"type": "resume"' in x]
    assert resumes and resumes[0]["win_start"] == (AT + CHUNK) * WINDOW_NS
    assert json.loads(r.stdout.strip().splitlines()[-1])["resumed"] is True
    _same_npz(straight, fin)


def test_supervisor_forwards_sigterm(tmp_path):
    """SIGTERM to the supervisor drains its child: EXIT_PREEMPTED."""
    ck = str(tmp_path / "ck.npz")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow1_tpu_torch", RUNG1, "--device", "cpu",
         "--windows", "500", "--heartbeat", str(CHUNK), "--ckpt-every-s",
         "0", "--ckpt", ck], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # Signal once the child has ticked its progress sidecar.
        deadline = time.monotonic() + 240
        while (not os.path.exists(ck + ".progress") and proc.poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == consts_t.EXIT_PREEMPTED, err[-800:]
    assert "forwarding drain request" in err
    assert json.loads(out.strip().splitlines()[-1])["preempted"] is True


def test_cli_watchdog_kills_and_recovers_hung_child(tmp_path, straight):
    fin = str(tmp_path / "fin.npz")
    r = _port("--ckpt", str(tmp_path / "ck.npz"), "--watchdog-s",
              str(WATCHDOG_S), "--save-state", fin,
              env={"SHADOW1_OBS_HANG_AT_NS": str(AT * WINDOW_NS),
                   "SHADOW1_OBS_HANG_ONCE_FLAG": str(tmp_path / "hung.flag")})
    assert r.returncode == 0, (r.returncode, r.stderr[-1500:])
    assert "child hung" in r.stderr and "watchdog_kill" in r.stderr
    assert "respawning" in r.stderr
    _same_npz(straight, fin)


@pytest.mark.slow  # two watchdog deadlines at 3x before a first beat
def test_cli_watchdog_classifies_deterministic_hang(tmp_path):
    r = _port("--ckpt", str(tmp_path / "ck.npz"), "--watchdog-s", "4",
              env={"SHADOW1_WATCHDOG_S": "100",
                   "SHADOW1_OBS_HANG_AT_NS": str(CHUNK * WINDOW_NS)})
    assert r.returncode == consts_t.EXIT_HUNG, (r.returncode,
                                                r.stderr[-1500:])
    assert "watchdog kills" in r.stderr
    assert r.stderr.count("respawning") == 1

"""The port's memory plane (``shadow1_tpu_torch/mem.py``) against the JAX
package's ``mem.py``, on the CPU.

* ``estimate``: the state planes (evbuf, outbox, model, metrics, telem,
  scalars, the restart capture) equal the JAX estimate's for every config
  (PHOLD, rung1, tgen, Tor, Bitcoin, churn8 with restarts, the
  probe/link planes); the resident bytes equal the unique storages of an
  ``Engine``'s ctx and ``init_state`` within ``AUDIT_TOLERANCE``, also at
  a migrated cap; a 1 M-host config is estimated on the meta device
  without a state-sized allocation;
* ``check_budget`` raises the structured ``MemoryBudgetError``;
  ``downshift`` drops the rollback copy, then shrinks the ring (never
  below 1 under the digest words, never under a resumable run), with the
  reference's records;
* ``is_oom`` classifies ``torch.cuda.OutOfMemoryError`` and the CUDA
  out-of-memory texts, never ``MemoryBudgetError``; the env budget wins;
* the CLI: the ``mem`` record, ``EXIT_MEMORY`` from pre-flight and from
  an injected runtime OOM, a downshift that demotes retry and still runs,
  and the supervisor's no-respawn classification of both a structured
  and a raw OOM exit.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from shadow1_tpu import mem as mem_j
from shadow1_tpu.config.experiment import load_experiment as load_j
from shadow1_tpu_torch import mem
from shadow1_tpu_torch.config.experiment import load_experiment as load_t
from shadow1_tpu_torch.consts import EXIT_MEMORY
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine
from shadow1_tpu_torch.tune.resize import resize_state
from tests.test_torch_ckpt import OBS_PARAMS, obs_experiment
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import _one_thread  # noqa: F401
from tests.test_torch_tune import both, phold_kw

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("sweep_phold", "rung1_filexfer", "rung2_tgen100", "rung3_tor1k",
           "rung5_bitcoin5k", "churn_filexfer")
SHARED = ("evbuf", "outbox", "model", "metrics", "telem", "scalars",
          "init_model")


def _yaml(name):
    exp_j, par_j, _ = load_j(str(ROOT / "configs" / f"{name}.yaml"))
    exp_t, par_t, _ = load_t(str(ROOT / "configs" / f"{name}.yaml"))
    return exp_j, par_j, exp_t, par_t


@pytest.mark.parametrize("name", CONFIGS)
def test_estimate_matches_reference_and_storages(name):
    exp_j, par_j, exp_t, par_t = _yaml(name)
    par_j = dataclasses.replace(par_j, on_overflow="retry")
    par_t = dataclasses.replace(par_t, on_overflow="retry")
    ej, et = mem_j.estimate(exp_j, par_j), mem.estimate(exp_t, par_t)
    assert {k: et.planes.get(k) for k in SHARED} == {
        k: ej.planes.get(k) for k in SHARED}
    assert et.state_bytes == ej.state_bytes
    assert et.peaks["rollback"] == ej.peaks["rollback"] == et.state_bytes
    eng = Engine(exp_t, par_t, device="cpu")
    st = eng.init_state()
    measured = mem.live_bytes(eng.ctx, st)
    assert abs(et.resident_bytes / measured - 1) <= mem.AUDIT_TOLERANCE, (
        et.resident_bytes, measured)
    assert et.peak_bytes > et.resident_bytes


def test_estimate_with_probe_and_link_planes():
    """The flow-probe ring and the link accumulator (the port's state
    leaves beyond the reference's estimate) count as planes of their own,
    and the resident bytes are the storages' exactly."""
    exp = obs_experiment()
    params = EngineParamsT(**OBS_PARAMS)
    est = mem.estimate(exp, params)
    assert est.planes["probes"] > 0 and est.planes["links"] > 0
    assert est.planes["init_model"] == est.planes["model"]
    eng = Engine(exp, params, device="cpu")
    assert est.resident_bytes == mem.live_bytes(eng.ctx, eng.init_state())
    est_j = mem_j.estimate(jax_experiment(exp), params_j(params))
    for k in ("evbuf", "outbox", "model", "metrics", "telem", "scalars"):
        assert est.planes[k] == est_j.planes[k], k


def params_j(params):
    from shadow1_tpu.consts import EngineParams as EngineParamsJ

    return EngineParamsJ(**dataclasses.asdict(params))


def test_estimate_after_cap_resize():
    """The estimate at a migrated cap prices what the migrated state
    holds."""
    _, exp = both(phold_kw(n_hosts=16, init_events=4))
    eng = Engine(exp, EngineParamsT(ev_cap=32, outbox_cap=16), device="cpu")
    st = resize_state(eng.run(n_windows=10), ev_cap=96)
    grown = dataclasses.replace(eng.params, ev_cap=96)
    est = mem.estimate(exp, grown)
    assert est.resident_bytes == mem.live_bytes(eng.at_caps(grown).ctx, st)


class _Biggest(TorchDispatchMode):
    """The largest non-meta tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.most = max(self.most, t.numel() * t.element_size())
        return out


def test_estimate_allocates_nothing_state_sized():
    _, exp = both(phold_kw(n_hosts=1 << 20))
    params = EngineParamsT(ev_cap=256, outbox_cap=32)
    with _Biggest() as seen:
        est = mem.estimate(exp, params)
    assert est.state_bytes > (16 << 30)  # a >16 GiB config...
    assert seen.most < (64 << 20), seen.most  # ...estimated in place


def test_check_budget_raises_structured_error():
    _, exp = both(phold_kw(n_hosts=16, init_events=4))
    params = EngineParamsT(ev_cap=32, outbox_cap=16, on_overflow="retry")
    est = mem.estimate(exp, params)
    with pytest.raises(mem.MemoryBudgetError) as ei:
        mem.check_budget(est, est.peak_bytes // 2, "env")
    e = ei.value
    assert e.estimated == est.peak_bytes and e.budget == est.peak_bytes // 2
    assert e.planes["evbuf"] > 0 and e.peaks["rollback"] > 0
    assert "--on-overflow halt" in e.advice and "downshift" in e.advice
    assert not mem.is_oom(e)
    mem.check_budget(est, None)
    mem.check_budget(est, est.peak_bytes)


def test_downshift_order_and_records_match_reference():
    kw = phold_kw(n_hosts=16, init_events=4)
    params = EngineParamsT(ev_cap=32, outbox_cap=16, on_overflow="retry",
                           metrics_ring=64)
    _, exp = both(kw)
    halt = dataclasses.replace(params, on_overflow="halt")
    floor = mem.estimate(exp, halt)
    ringless = mem.estimate(exp, dataclasses.replace(halt, metrics_ring=0))
    # Between the halt and the ringless peaks: both stages are needed.
    budget = (floor.peak_bytes + ringless.peak_bytes) // 2
    pt, at = mem.downshift(exp, params, budget)
    assert [a["action"] for a in at] == ["drop_rollback", "shrink_ring"]
    assert pt.on_overflow == "halt" and 0 < pt.metrics_ring < 64
    assert mem.estimate(exp, pt).peak_bytes <= budget
    # The rollback stage alone: a budget above the halt peak.
    pt2, at2 = mem.downshift(exp, params, floor.peak_bytes)
    assert [a["action"] for a in at2] == ["drop_rollback"]
    assert at2[0]["freed"] == mem.estimate(exp, params).peaks["rollback"]
    assert pt2.metrics_ring == 64
    rec = mem.downshift_record(at, mem.estimate(exp, pt).peak_bytes, budget)
    assert rec["type"] == "mem" and rec["event"] == "downshift"
    # The reference's record and action schema. (Its planner prices its
    # own, XLA's, transients, so at one budget it may stop elsewhere.)
    assert rec == {**mem_j.downshift_record(at, rec["estimated_peak"],
                                            budget)}
    assert set(at2[0]) == {"action", "on_overflow", "freed"}
    assert set(at[1]) == {"action", "metrics_ring", "freed"}


def test_downshift_keeps_the_ring_for_digests_and_resumes():
    kw = phold_kw(n_hosts=16, init_events=4)
    _, exp = both(kw)
    params = EngineParamsT(ev_cap=32, outbox_cap=16, metrics_ring=64,
                           state_digest=1)
    tiny = mem.estimate(exp, dataclasses.replace(params, metrics_ring=1))
    with pytest.raises(mem.MemoryBudgetError, match="exhausted"):
        mem.downshift(exp, params, tiny.peak_bytes // 4)
    p2, actions = mem.downshift(exp, params, tiny.peak_bytes + 64)
    assert p2.metrics_ring == 1 and p2.state_digest == 1
    assert actions[0]["action"] == "shrink_ring"
    retry = dataclasses.replace(params, on_overflow="retry", state_digest=0)
    no_roll = mem.estimate(exp, dataclasses.replace(retry, on_overflow="halt"))
    ringless = mem.estimate(exp, dataclasses.replace(
        retry, on_overflow="halt", metrics_ring=0))
    budget = (no_roll.peak_bytes + ringless.peak_bytes) // 2
    with pytest.raises(mem.MemoryBudgetError, match="snapshot shape"):
        mem.downshift(exp, retry, budget, resumable=True)


def test_is_oom_taxonomy():
    assert mem.is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)"))
    assert mem.is_oom(RuntimeError("CUDA error: out of memory\nCUDA kernel "
                                   "errors might be asynchronously reported"))
    assert mem.is_oom(RuntimeError(
        "CUDA kernel 'pop' failed to launch: CUDA error: out of memory "
        "(cudaError 2)"))
    assert mem.is_oom(MemoryError())
    assert not mem.is_oom(RuntimeError("CUDA error: an illegal memory "
                                       "access was encountered"))
    from shadow1_tpu_torch.txn import CapacityExceededError

    assert not mem.is_oom(CapacityExceededError(
        "ev_cap", "ev_overflow", 8, 1, (0, 10)))
    assert not mem.is_oom(mem.MemoryBudgetError(
        2, 1, {}, {}, "advice: CUDA out of memory"))
    assert mem.is_oom_text("torch.OutOfMemoryError: CUDA out of memory.")
    assert not mem.is_oom_text("{\"type\": \"heartbeat\"}")


def test_device_budget(monkeypatch):
    monkeypatch.setenv(mem.MEM_BYTES_ENV, str(123 << 20))
    assert mem.device_budget() == (123 << 20, "env")
    assert mem_j.device_budget() == (123 << 20, "env")
    monkeypatch.setenv(mem.MEM_BYTES_ENV, "8GiB")
    assert mem.device_budget("cpu") == (None, None)
    monkeypatch.delenv(mem.MEM_BYTES_ENV)
    assert mem.device_budget("cpu") == (None, None)
    assert mem.device_peak_in_use("cpu") is None


ENV = {**os.environ, "OMP_NUM_THREADS": "1", "SHADOW1_SUPERVISE_BACKOFF_S": "0"}


def _cfg(tmp_path) -> str:
    cfg = tmp_path / "mem_phold.yaml"
    cfg.write_text(
        "general: {seed: 5, stop_time: 20 ms}\n"
        "engine: {scheduler: tpu, ev_cap: 32}\n"
        "network: {single_vertex: {latency: 1 ms}}\n"
        "hosts:\n"
        "  - {name: h, count: 16}\n"
        "app:\n"
        "  model: phold\n"
        "  params: {mean_delay_ns: 2000000.0, init_events: 4}\n")
    return str(cfg)


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch", *args, "--device", "cpu"],
        cwd=ROOT, env={**ENV, **(env or {})}, capture_output=True, text=True,
        timeout=300)


def _mem_records(stderr: str) -> list:
    return [json.loads(x) for x in stderr.splitlines()
            if x.startswith("{") and '"type": "mem"' in x]


def test_cli_preflight_record_and_exit_memory(tmp_path):
    cfg = _cfg(tmp_path)
    r = _cli(cfg, "--windows", "5", env={mem.MEM_BYTES_ENV: str(1 << 30)})
    assert r.returncode == 0, r.stderr[-800:]
    rec = _mem_records(r.stderr)[0]
    assert rec["event"] == "estimate" and rec["budget"] == 1 << 30
    assert rec["budget_source"] == "env" and rec["headroom"] > 0
    assert rec["planes"]["evbuf"] > 0
    r = _cli(cfg, env={mem.MEM_BYTES_ENV: "30000"})
    assert r.returncode == EXIT_MEMORY, (r.returncode, r.stderr[-600:])
    err = json.loads(r.stdout.strip().splitlines()[-1])
    assert err["error"] == "memory_budget" and err["budget"] == 30000
    assert err["estimated"] > 30000 and err["planes"]["evbuf"] > 0
    assert "Remedies" in err["advice"] and "MemoryBudgetError" in r.stderr


def test_cli_downshift_demotes_retry_and_runs(tmp_path):
    cfg = _cfg(tmp_path)
    exp, params, _ = load_t(cfg)
    p = dataclasses.replace(params, on_overflow="retry", metrics_ring=10)
    est = mem.estimate(exp, p)
    budget = est.peak_bytes - est.peaks["rollback"] + 512
    r = _cli(cfg, "--windows", "10", "--on-overflow", "retry",
             "--metrics-ring", "10", "--on-oom", "downshift",
             env={mem.MEM_BYTES_ENV: str(budget)})
    assert r.returncode == 0, r.stderr[-800:]
    ds = [x for x in _mem_records(r.stderr) if x["event"] == "downshift"]
    assert ds and ds[0]["actions"][0]["action"] == "drop_rollback"
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["retries"]["policy"] == "halt"


def test_cli_runtime_oom_exit_memory(tmp_path):
    cfg = _cfg(tmp_path)
    r = _cli(cfg, "--windows", "5", env={"SHADOW1_MEM_INJECT_OOM": "run"})
    assert r.returncode == EXIT_MEMORY, (r.returncode, r.stderr[-600:])
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["error"] == "memory_exhausted" and rec["phase"] == "run"
    assert "CUDA out of memory" in rec["message"]


@pytest.mark.parametrize("inject", ["budget", "raw", "run"])
def test_supervisor_does_not_respawn_oom(tmp_path, inject):
    """Under --ckpt, EXIT_MEMORY (pre-flight, or an OOM injected into the
    run) and a raw CUDA OOM crash (the taxonomy bypassed: a generic exit
    code, the error on stderr) are deterministic: classified, never
    respawned."""
    cfg = _cfg(tmp_path)
    env = ({mem.MEM_BYTES_ENV: "30000"} if inject == "budget"
           else {"SHADOW1_MEM_INJECT_OOM": inject})
    r = _cli(cfg, "--ckpt", str(tmp_path / "ck.npz"), "--heartbeat", "5",
             env=env)
    assert r.returncode == EXIT_MEMORY, (r.returncode, r.stderr[-600:])
    how = ("(rc=1, raw CUDA out-of-memory on stderr)" if inject == "raw"
           else "(rc=EXIT_MEMORY)")
    assert f"exhausted device memory {how}" in r.stderr
    assert "respawning (" not in r.stderr
    if inject == "raw":
        assert "injected raw OOM" in r.stderr

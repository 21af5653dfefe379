"""Slice 1 of the port: PHOLD through the event core, against the JAX engine.

Every ``Metrics`` field — ``rounds`` included — and the per-host hop counts
of the port's ``Engine(device="cpu")`` must equal the JAX ``Engine``'s on
the same experiment; so must a run that starts from a JAX state carried
across mid-run, and the port's command line. The package itself must
import no JAX and nothing of ``shadow1_tpu``, refuse what the slice does
not run, and refuse to run without a card unless asked for the CPU.
"""

import copy
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from shadow1_tpu.config import compiled as cj
from shadow1_tpu.config import experiment as xj
from shadow1_tpu.consts import MS, EngineParams
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config import experiment as xt
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "shadow1_tpu_torch"


def _doc(name: str) -> dict:
    with open(ROOT / "configs" / name) as f:
        return yaml.safe_load(f)


def _serve_doc():
    doc = _doc("serve_phold.yaml")
    for k in ("metrics_ring", "state_digest"):
        doc["engine"].pop(k)
    return doc


def _lossy_doc():
    doc = _doc("sweep_phold.yaml")
    doc["network"]["single_vertex"]["loss"] = 0.05
    return doc


BENCH_LIKE = dict(n_hosts=1024, seed=1234, end_time=10 * MS,
                  latency_ns=1 * MS, model="phold",
                  model_cfg={"mean_delay_ns": 2.0 * MS, "init_events": 16})
BENCH_PARAMS = dict(ev_cap=48, outbox_cap=24, max_rounds=128)


def _case(name: str):
    """(jax (exp, params), port (exp, params)) of a named slice config."""
    if name == "bench_like":
        return ((cj.single_vertex_experiment(**BENCH_LIKE),
                 EngineParams(**BENCH_PARAMS)),
                (ct.single_vertex_experiment(**BENCH_LIKE),
                 EngineParamsT(**BENCH_PARAMS)))
    doc = {"serve": _serve_doc, "sweep": lambda: _doc("sweep_phold.yaml"),
           "lossy": _lossy_doc}[name]()
    exp_j, par_j, _ = xj.build_experiment(copy.deepcopy(doc))
    exp_t, par_t, _ = xt.build_experiment(copy.deepcopy(doc))
    return (exp_j, par_j), (exp_t, par_t)


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, n_windows: int | None = None):
    """The JAX engine's result: (metrics, hops, numpy state)."""
    (exp, params), _ = _case(name)
    eng = EngineJ(exp, params)
    st = eng.run(n_windows=n_windows)
    return (EngineJ.metrics_dict(st),
            np.asarray(eng.model_summary(st)["hops"]),
            jax.tree.map(np.asarray, st))


CASES = ["serve", "sweep", "lossy", "bench_like"]


@pytest.mark.parametrize("name", CASES)
def test_engine_matches_jax(name):
    mj, hops_j, _ = _jax_run(name)
    _, (exp, params) = _case(name)
    eng = EngineT(exp, params, device="cpu")
    st = eng.run()
    mt = EngineT.metrics_dict(st)
    assert list(mt) == list(mj)
    assert mt == mj
    assert mt["events"] > 0 and mt["pkts_sent"] > 0
    if name == "lossy":
        assert mt["pkts_lost"] > 0
    summ = eng.model_summary(st)
    np.testing.assert_array_equal(summ["hops"], hops_j)
    assert int(summ["total_hops"]) == int(hops_j.sum()) == mt["events"]


@pytest.mark.parametrize("k", [3, 9])
def test_state_carried_from_jax(k):
    """Run JAX for k windows, carry the state across, finish on the port:
    metrics and every state leaf equal the straight JAX run's."""
    mj, _, st_full = _jax_run("lossy")
    (exp_j, par_j), (exp_t, par_t) = _case("lossy")
    eng_j = EngineJ(exp_j, par_j)
    st_k = jax.tree.map(np.asarray, eng_j.run(n_windows=k))
    eng_t = EngineT(exp_t, par_t, device="cpu")
    st = eng_t.run(convert.state_from_numpy(st_k, "cpu"),
                   n_windows=eng_t.n_windows - k)
    assert EngineT.metrics_dict(st) == mj
    back = convert.state_to_numpy(st)
    for a, b in zip(jax.tree.leaves(st_full), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, **(env or {})})


def test_cli_cpu_matches_jax():
    mj, hops_j, _ = _jax_run("sweep", 6)
    out = _cli("configs/sweep_phold.yaml", "--device", "cpu", "--windows", "6")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metrics"] == mj
    assert rec["summary"] == {"total_hops": int(hops_j.sum())}
    assert rec["device"] == "cpu"


def test_cli_without_cuda_fails():
    """No card visible and no --device cpu: the entry point exits non-zero
    and prints no result."""
    out = _cli("configs/sweep_phold.yaml", "--windows", "1",
               env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, (exp, params) = _case("sweep")
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineT(exp, params)


def _unsupported(kind: str):
    doc = _doc("sweep_phold.yaml")
    if kind == "faults":
        doc["faults"] = {"hosts": [{"group": "h", "down_at": "50 ms",
                                    "up_at": "100 ms"}]}
    elif kind == "ring":
        # A NIC queue bound (the ring and digest knobs run since slice 2).
        doc["hosts"][0]["tx_queue_bytes"] = 30000
    elif kind == "compact":
        doc["engine"]["compact_cap"] = 16
    elif kind == "cpu":
        doc["hosts"][0]["cpu_per_event"] = "1 us"
    elif kind == "jitter":
        doc["network"]["jitter"] = "1 ms"
    elif kind == "retry":
        doc["engine"]["on_overflow"] = "retry"
    return doc


@pytest.mark.parametrize("kind", ["net", "faults", "ring", "compact", "cpu",
                                  "jitter", "retry"])
def test_unsupported_configs_fail_loudly(kind):
    """The name is historical: each of these configs once was refused,
    and the test keeps its name and its cases so that its record holds
    (``test_torch_app_configs.py test_check_supported_refuses`` holds the
    refusals that stand). Since the fault and fidelity slice every one
    runs: ``net`` (the Bitcoin app of rung5_bitcoin5k) builds its engine,
    and PHOLD under a fault schedule, a NIC queue bound, compaction, the
    virtual CPU or edge jitter equals the JAX engine; since the recovery
    planes ``on_overflow: retry`` runs too, its chunks under each
    package's overflow guard, with the same metrics and guard report."""
    if kind == "retry":
        from shadow1_tpu.ckpt import run_chunked as run_j
        from shadow1_tpu.txn import OverflowGuard as GuardJ
        from shadow1_tpu_torch.ckpt import run_chunked as run_t
        from shadow1_tpu_torch.txn import OverflowGuard as GuardT

        exp_j, par_j, _ = xj.build_experiment(_unsupported(kind))
        exp_t, par_t, _ = xt.build_experiment(_unsupported(kind))
        assert par_t.on_overflow == "retry"
        eng_j = EngineJ(exp_j, par_j)
        g_j = GuardJ(eng_j, make_engine=lambda p: EngineJ(exp_j, p))
        st_j = run_j(eng_j, chunk=10, guard=g_j)
        eng_t = EngineT(exp_t, par_t, device="cpu")
        g_t = GuardT(eng_t, make_engine=eng_t.at_caps)
        st_t = run_t(eng_t, chunk=10, guard=g_t)
        assert EngineT.metrics_dict(st_t) == EngineJ.metrics_dict(st_j)
        assert g_t.report() == g_j.report() and g_t.resizes == g_j.resizes
        return
    if kind == "net":
        exp, params, _ = xt.load_experiment(
            str(ROOT / "configs" / "rung5_bitcoin5k.yaml"))
        EngineT(exp, params, device="cpu")
        return
    if kind == "compact":
        # compact_cap runs since the app slice (core/compact.py): PHOLD with
        # a 16-lane bucket is bit-equal to PHOLD without one.
        exp, params, _ = xt.build_experiment(_unsupported(kind))
        st = EngineT(exp, params, device="cpu").run(n_windows=8)
        plain = EngineT(exp, dataclasses.replace(params, compact_cap=0),
                        device="cpu").run(n_windows=8)
        assert EngineT.metrics_dict(st) == EngineT.metrics_dict(plain)
        np.testing.assert_array_equal(st.model.hops.numpy(),
                                      plain.model.hops.numpy())
        return
    exp_j, par_j, _ = xj.build_experiment(_unsupported(kind))
    exp_t, par_t, _ = xt.build_experiment(_unsupported(kind))
    eng_j = EngineJ(exp_j, par_j)
    st_j = eng_j.run()
    eng_t = EngineT(exp_t, par_t, device="cpu")
    st_t = eng_t.run()
    mt = EngineT.metrics_dict(st_t)
    assert mt == EngineJ.metrics_dict(st_j)
    np.testing.assert_array_equal(eng_t.model_summary(st_t)["hops"],
                                  np.asarray(eng_j.model_summary(st_j)["hops"]))
    if kind == "faults":
        assert mt["down_events"] > 0 and mt["host_restarts"] > 0
    if kind == "cpu":
        assert int(st_t.cpu_busy.max()) > 0
        np.testing.assert_array_equal(st_t.cpu_busy.numpy(),
                                      np.asarray(st_j.cpu_busy))


def test_serve_phold_ring_and_digests_match_jax():
    """serve_phold.yaml with its own metrics_ring and state_digest knobs:
    the port's ring rows — counter deltas, gauges and the per-window digest
    words — equal the JAX engine's, window by window."""
    from shadow1_tpu.telemetry.ring import drain_ring as drain_j
    from shadow1_tpu_torch.telemetry.ring import drain_ring as drain_t

    doc = _doc("serve_phold.yaml")
    assert doc["engine"]["metrics_ring"] and doc["engine"]["state_digest"]
    exp_j, par_j, _ = xj.build_experiment(copy.deepcopy(doc))
    exp_t, par_t, _ = xt.build_experiment(copy.deepcopy(doc))
    eng_j = EngineJ(exp_j, par_j)
    st_j = eng_j.run()
    eng_t = EngineT(exp_t, par_t, device="cpu")
    st_t = eng_t.run()
    assert EngineT.metrics_dict(st_t) == EngineJ.metrics_dict(st_j)
    rows_j = drain_j(st_j, exp_j.window, start=eng_j.n_windows - par_j.metrics_ring)
    rows_t = drain_t(st_t, exp_t.window, start=eng_t.n_windows - par_t.metrics_ring)
    assert len(rows_t) == par_t.metrics_ring and rows_t == rows_j
    assert all(r["dg_evbuf"] and r["dg_rng"] for r in rows_t)
    assert all(r["dg_tcp"] == r["dg_nic"] == 0 for r in rows_t)


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX unloaded, and no file
    of the port names JAX or the JAX package."""
    mods = sorted(
        "shadow1_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name not in ("__init__.py", "__main__.py"))
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'shadow1_tpu' or m.startswith('shadow1_tpu.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    for p in PKG.rglob("*"):
        if p.suffix not in (".py", ".cu"):
            continue
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (p, line)
            assert "import shadow1_tpu " not in s + " " and \
                not s.startswith("from shadow1_tpu.") and \
                not s.startswith("from shadow1_tpu "), (p, line)

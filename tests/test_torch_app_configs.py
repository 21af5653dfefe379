"""The app configurations of the tgen, dgram and Tor slice, against the
JAX package, on the CPU.

* ``build_experiment`` of the port gives, array for array, the JAX
  package's ``CompiledExperiment`` and ``EngineParams`` for
  ``configs/rung2_tgen100.yaml``, ``dense_tgen50k.yaml``,
  ``rung3_tor1k.yaml`` and ``rung4_tor10k.yaml``;
* ``experiment_arrays`` round-trips each of them unchanged, bool arrays
  and the ``params:`` scalars included, and leaves memoized caches out;
* each in-code builder of ``config/compiled.py`` behind a card run
  (``tools/torch_golden.py``) equals the YAML compile of the config it
  stands for, and the golden's engine parameters are the config's;
* ``check_supported`` accepts tgen, dgram, Tor, ``compact_cap``, Bitcoin,
  the NIC queue bounds, RED AQM, ``faults:``, ``probes:`` and
  ``link_telem``, and since the recovery planes ``selfcheck``,
  ``auto_caps`` and ``on_overflow: retry``, which run rung 2 equal to the
  JAX engine;
* the command line runs rung 2 and rung 3 (with its ``compact_cap``).
"""

import copy
import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from shadow1_tpu.config import experiment as xj
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config import experiment as xt
from shadow1_tpu_torch.consts import EngineParams
from shadow1_tpu_torch.core.engine import check_supported

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
YAMLS = ("rung2_tgen100", "dense_tgen50k", "rung3_tor1k", "rung4_tor10k")


def _doc(name):
    with open(CONFIGS / f"{name}.yaml") as f:
        return yaml.safe_load(f)


def _both(name):
    doc = _doc(name)
    exp_j, par_j, _ = xj.build_experiment(copy.deepcopy(doc),
                                          base_dir=str(CONFIGS))
    exp_t, par_t, _ = xt.build_experiment(copy.deepcopy(doc),
                                          base_dir=str(CONFIGS))
    return exp_j, par_j, exp_t, par_t


def _same_value(a, b, what):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("name", YAMLS)
def test_build_experiment_matches_jax(name):
    exp_j, par_j, exp_t, par_t = _both(name)
    assert dataclasses.asdict(par_t) == dataclasses.asdict(par_j)
    for f in dataclasses.fields(ct.CompiledExperiment):
        if f.name in ("model_cfg", "dns", "faults"):
            continue
        _same_value(getattr(exp_j, f.name), getattr(exp_t, f.name), f.name)
    assert exp_j.faults is None and exp_t.faults is None
    assert list(exp_t.model_cfg) == list(exp_j.model_cfg)
    for k, v in exp_j.model_cfg.items():
        _same_value(v, exp_t.model_cfg[k], f"model_cfg[{k!r}]")


@pytest.mark.parametrize("name", YAMLS)
def test_experiment_arrays_round_trip(name):
    _, _, exp, _ = _both(name)
    rec = ct.experiment_arrays(exp)
    back = ct.experiment_from_arrays(json.loads(json.dumps(rec)))
    assert ct.experiment_arrays(back) == rec
    for k, v in exp.model_cfg.items():
        _same_value(v, back.model_cfg[k], f"model_cfg[{k!r}]")
    for f in ct._ARRAY_FIELDS:
        _same_value(getattr(exp, f), getattr(back, f), f)


def test_experiment_arrays_leaves_caches_out():
    _, _, exp, _ = _both("rung3_tor1k")
    rec = ct.experiment_arrays(exp)
    exp.model_cfg["_tor_tables"] = {"guard_ids": np.arange(3)}
    assert ct.experiment_arrays(exp) == rec
    exp.model_cfg["bad"] = {"a": 1}
    with pytest.raises(TypeError, match="bad"):
        ct.experiment_arrays(exp)


def _golden_specs():
    spec = importlib.util.spec_from_file_location(
        "torch_golden", ROOT / "tools" / "torch_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.NET_CONFIGS


# card run -> the config its builder stands for
BUILT_FROM = {"tgen50k": "dense_tgen50k", "rung2": "rung2_tgen100",
              "tor10k": "rung4_tor10k"}


@pytest.mark.parametrize("run", list(BUILT_FROM))
def test_card_builders_equal_yaml(run):
    spec = _golden_specs()[run]
    _, _, exp_y, par_y = _both(BUILT_FROM[run])
    (builder, kwargs), = spec["build"].items()
    exp_b = getattr(ct, builder)(**dict(kwargs, end_time=exp_y.end_time))
    assert ct.experiment_arrays(exp_b) == ct.experiment_arrays(exp_y)
    assert dataclasses.replace(EngineParams(), **spec["params"]) == par_y


def test_rung3_builder_equals_yaml():
    _, _, exp_y, _ = _both("rung3_tor1k")
    ms, sec = 1_000_000, 1_000_000_000
    exp_b = ct.tor_experiment(
        n_guard=30, n_middle=60, n_exit=30, n_dirauth=5, n_client=875,
        seed=33, end_time=60 * sec, latency_ns=30 * ms,
        relay_bw=100_000_000, client_bw=20_000_000, n_circuits=3,
        n_streams=3, mean_stream_cells=40.0, mean_think_ns=2.0 * sec,
        start_time=100 * ms, ct_cap=512)
    assert ct.experiment_arrays(exp_b) == ct.experiment_arrays(exp_y)


def test_check_supported():
    for name in YAMLS:
        _, _, exp, par = _both(name)
        check_supported(exp, par)                 # tgen, tor, compact_cap
    dg = ct.dgram_ring_experiment(8, 1, 10**9, latency_ns=10**7, loss=0.0,
                                  payload=100, interval=10**6, count=2,
                                  start_time=0)
    check_supported(dg, EngineParams(compact_cap=4))
    # Refused until the fault and fidelity slice, accepted since: Bitcoin,
    # the NIC queue bounds, RED AQM and a faults: section.
    accepted = [
        ("rung5_bitcoin5k", None),
        ("rung2_tgen100", {"tx_queue_bytes": 30000}),
        ("rung2_tgen100", {"rx_queue_bytes": 30000}),
        ("rung2_tgen100", {"aqm_max_bytes": 30000, "aqm_min_bytes": 10}),
    ]
    for name, host_knobs in accepted:
        doc = _doc(name)
        if host_knobs:
            doc["hosts"][0].update(host_knobs)
        exp, par, _ = xt.build_experiment(doc, base_dir=str(CONFIGS))
        check_supported(exp, par)
    doc = _doc("rung2_tgen100")
    doc["faults"] = {"hosts": [{"host": 1, "down_at": "1 s"}]}
    exp, par, _ = xt.build_experiment(doc, base_dir=str(CONFIGS))
    assert exp.faults is not None
    check_supported(exp, par)
    # Refused until the checkpoint and observability slice, accepted
    # since: a probes: section resolves as the reference's, and one the
    # reference cannot resolve fails as it does there.
    doc = _doc("rung2_tgen100")
    doc["probes"] = [{"host": 0, "sock": 1}, "1"]
    exp, par, _ = xt.build_experiment(copy.deepcopy(doc),
                                      base_dir=str(CONFIGS))
    _, par_j, _ = xj.build_experiment(copy.deepcopy(doc),
                                      base_dir=str(CONFIGS))
    assert par.probes == par_j.probes == ((0, 1), (1, -1))
    check_supported(exp, par)
    doc["probes"] = {"flows": [{"host": 0, "sock": 1}]}
    for mod in (xt, xj):
        with pytest.raises(mod.WatchlistError, match="flows"):
            mod.build_experiment(copy.deepcopy(doc), base_dir=str(CONFIGS))


@functools.lru_cache(maxsize=None)
def _jax_rung2(windows: int) -> dict:
    """The JAX engine's metrics after ``windows`` windows of rung 2."""
    from shadow1_tpu.core.engine import Engine as EngineJ

    exp_j, par_j, _, _ = _both("rung2_tgen100")
    return EngineJ.metrics_dict(EngineJ(exp_j, par_j).run(n_windows=windows))


@pytest.mark.parametrize("knob", [dict(selfcheck=1), dict(auto_caps=1),
                                  dict(on_overflow="retry"),
                                  dict(link_telem=1)])
def test_check_supported_refuses(knob):
    """The name is historical: ``selfcheck: 1``, ``auto_caps`` and
    ``on_overflow: retry`` were refused until the recovery planes, and
    ``link_telem`` until the checkpoint and observability slice. Each is
    accepted now. Rung 2 runs 5 windows in chunks of one under the plane
    the knob asks for (the boundary identity; the cap controller, which
    shrinks into overflow on its own, with the retry guard that keeps it
    lossless; the retry guard) and equals the JAX engine's straight run;
    the link accumulator rides the state."""
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.core.engine import Engine

    _, _, exp, par = _both("rung2_tgen100")
    params = dataclasses.replace(par, **knob)
    check_supported(exp, params)
    eng = Engine(exp, params, device="cpu")
    if "link_telem" in knob:
        st = eng.init_state()
        assert tuple(st.links.buf.shape) == (1, 1, 7)
        return
    hooks = {}
    if params.auto_caps:
        from shadow1_tpu_torch.tune import CapController

        hooks["retune"] = ctl = CapController(eng, eng.at_caps)
    if params.on_overflow == "retry" or params.auto_caps:
        from shadow1_tpu_torch.txn import OverflowGuard

        hooks["guard"] = guard = OverflowGuard(
            eng, make_engine=eng.at_caps, controller=hooks.get("retune"))
    torch.set_num_threads(1)
    st = run_chunked(eng, n_windows=5, chunk=1,
                     selfcheck=bool(params.selfcheck), **hooks)
    assert Engine.metrics_dict(st) == _jax_rung2(5)
    if params.auto_caps:
        assert ctl.resizes and guard.final_caps["ev_cap"] < par.ev_cap
    if params.on_overflow == "retry":
        assert guard.report()["chunk_retries"] == 0


@pytest.mark.parametrize("config", ["rung2_tgen100", "rung3_tor1k"])
def test_cli_runs_app(config, capsys):
    """``python -m shadow1_tpu_torch CFG --device cpu --windows 5`` (run
    in process with one torch thread). Rung 2's metrics equal the JAX
    engine's; rung 3 runs with its compact_cap of 384: no host is active
    before its 875 clients start at 100 ms, in window 4, which runs full
    width."""
    import torch

    from shadow1_tpu_torch import cli
    from shadow1_tpu_torch.core import compact

    for k in compact.WINDOWS:
        compact.WINDOWS[k] = 0

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main([str(CONFIGS / f"{config}.yaml"), "--device", "cpu",
                         "--windows", "5"]) == 0
    finally:
        torch.set_num_threads(n)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["windows"] == 5 and res["metrics"]["events"] > 0
    exp_j, par_j, _, par_t = _both(config)
    if config == "rung3_tor1k":
        assert par_t.compact_cap == 384
        assert res["metrics"]["compact_max_fill"] > 384
        assert compact.WINDOWS["compact"] > 0 and compact.WINDOWS["full"] > 0
        return
    assert res["metrics"] == _jax_rung2(5)

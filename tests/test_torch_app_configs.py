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
  the NIC queue bounds, RED AQM and ``faults:``, and refuses ``probes:``,
  ``selfcheck``, ``auto_caps``, ``on_overflow: retry`` and ``link_telem``,
  each naming its ROADMAP item;
* the command line runs rung 2 and rung 3 (with its ``compact_cap``).
"""

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
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
    # What still refuses names its ROADMAP item.
    doc = _doc("rung2_tgen100")
    doc["probes"] = {"flows": [{"host": 0, "sock": 1}]}
    with pytest.raises(NotImplementedError, match="checkpoint and "
                       "observability"):
        xt.build_experiment(doc, base_dir=str(CONFIGS))


@pytest.mark.parametrize("knob", [dict(selfcheck=1), dict(auto_caps=1),
                                  dict(on_overflow="retry"),
                                  dict(link_telem=1)])
def test_check_supported_refuses(knob):
    """``selfcheck: 1`` (the reference's boundary identity, which the
    port does not run yet), ``auto_caps``, ``on_overflow: retry`` and
    ``link_telem`` are refused, naming their ROADMAP item."""
    _, _, exp, _ = _both("rung2_tgen100")
    item = ("checkpoint and observability" if "link_telem" in knob
            else "recovery planes")
    with pytest.raises(NotImplementedError, match=item):
        check_supported(exp, EngineParams(**knob))


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
    from shadow1_tpu.core.engine import Engine as EngineJ

    st = EngineJ(exp_j, par_j).run(n_windows=5)
    assert res["metrics"] == EngineJ.metrics_dict(st)

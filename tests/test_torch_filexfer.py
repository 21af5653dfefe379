"""Slice 2 of the port on a lossy filexfer: the layout of the card's
``filexfer16k`` configuration (``tiled_filexfer_experiment``) at 16 hosts —
2 groups of a server and 7 clients — with 2 % path loss, 40 windows, so
fast retransmit, RTO and FIN/close all run.

The port's ``Engine(device="cpu")`` must equal the JAX ``Engine`` bit for
bit: every ``Metrics`` field, every summary array, every ring row (the
per-window digest words included) and every state leaf at windows 15 and
40; and a JAX state carried into the port at window 15 goes on
bit-exactly. The JAX reference runs once per module.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from shadow1_tpu.config import compiled as cj
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.telemetry.ring import drain_ring as drain_j
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.telemetry.ring import drain_ring as drain_t

WINDOWS, MID = 40, 15
PARAMS = dict(ev_cap=512, metrics_ring=WINDOWS, state_digest=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _experiments():
    exp_t = ct.tiled_filexfer_experiment(2, seed=42,
                                         end_time=WINDOWS * 40_000_000,
                                         loss=0.02)
    exp_j = cj.CompiledExperiment(**{
        f.name: getattr(exp_t, f.name)
        for f in dataclasses.fields(cj.CompiledExperiment)})
    return exp_j, exp_t


def _np_tree(st):
    return jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def jax_run():
    exp, _ = _experiments()
    eng = EngineJ(exp, EngineParamsJ(**PARAMS))
    st_mid = eng.run(n_windows=MID)
    st_end = eng.run(st_mid, n_windows=WINDOWS - MID)
    return types.SimpleNamespace(
        mid=_np_tree(st_mid), end=_np_tree(st_end),
        rows=drain_j(st_end, exp.window),
        metrics=EngineJ.metrics_dict(st_end),
        summary=jax.tree.map(np.asarray, eng.model_summary(st_end)))


def _assert_same_leaves(want, got):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    lg = jax.tree.leaves(got)
    assert len(flat) == len(lg)
    for (path, a), b in zip(flat, lg):
        path = jax.tree_util.keystr(path)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=path)


def test_experiment_matches_yaml_layout():
    """tiled_filexfer_experiment gives the per-host app arrays and topology
    that the YAML loader gives configs/churn_filexfer.yaml's host groups
    (faults: left out)."""
    import copy
    from pathlib import Path

    import yaml

    from shadow1_tpu_torch.config import experiment as xt

    configs = Path(__file__).resolve().parents[1] / "configs"
    with open(configs / "churn_filexfer.yaml") as f:
        doc = yaml.safe_load(f)
    doc.pop("faults")
    exp_y, _, _ = xt.build_experiment(copy.deepcopy(doc),
                                      base_dir=str(configs))
    exp_b = ct.tiled_filexfer_experiment(1, seed=42, end_time=exp_y.end_time)
    assert exp_b.n_hosts == exp_y.n_hosts == 8
    for f in ("lat_vv", "loss_vv", "host_vertex", "bw_up", "bw_dn"):
        np.testing.assert_array_equal(getattr(exp_b, f), getattr(exp_y, f))
    assert set(exp_b.model_cfg) == set(exp_y.model_cfg)
    for k, v in exp_y.model_cfg.items():
        if k != "app":
            assert exp_b.model_cfg[k].dtype == v.dtype
            np.testing.assert_array_equal(exp_b.model_cfg[k], v, err_msg=k)
    rebuilt = ct.experiment_from_arrays(ct.experiment_arrays(exp_b))
    assert ct.experiment_arrays(rebuilt) == ct.experiment_arrays(exp_b)


def test_lossy_filexfer_matches_jax(jax_run):
    _, exp = _experiments()
    eng = EngineT(exp, EngineParamsT(**PARAMS), device="cpu")
    st_mid = eng.run(n_windows=MID)
    _assert_same_leaves(jax_run.mid, convert.state_to_numpy(st_mid))
    st = eng.run(st_mid, n_windows=WINDOWS - MID)
    mt = EngineT.metrics_dict(st)
    assert list(mt) == list(jax_run.metrics) and mt == jax_run.metrics
    for k in ("tcp_fast_rtx", "tcp_rto", "pkts_lost", "tcp_ooo_drops"):
        assert mt[k] > 0, k
    for k in ("ev_overflow", "ob_overflow", "round_cap_hits"):
        assert mt[k] == 0, k
    summ = eng.model_summary(st)
    assert int(summ["total_flows_done"]) > 0
    assert set(summ) == set(jax_run.summary)
    for k, v in jax_run.summary.items():
        np.testing.assert_array_equal(summ[k], v, err_msg=k)
    assert drain_t(st, exp.window) == jax_run.rows
    _assert_same_leaves(jax_run.end, convert.state_to_numpy(st))


def test_state_carried_from_jax(jax_run):
    _, exp = _experiments()
    eng = EngineT(exp, EngineParamsT(**PARAMS), device="cpu")
    st = eng.run(convert.state_from_numpy(jax_run.mid, "cpu"),
                 n_windows=WINDOWS - MID)
    assert EngineT.metrics_dict(st) == jax_run.metrics
    assert drain_t(st, exp.window) == jax_run.rows
    _assert_same_leaves(jax_run.end, convert.state_to_numpy(st))

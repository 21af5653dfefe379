"""The exchange bucket (``x2x_cap``) and the recovery planes of the
sharded engine, on gloo CPU ranks against the JAX ``ShardedEngine`` at
the same device count: a tiny explicit cap drops and counts what the
reference counts (``check_x2x=False``) or raises; ``txn.OverflowGuard``
grows ``ev_cap`` on every rank and commits the reference's run; and
``mem.estimate(n_dev=2)`` prices one rank as the reference does where
the two memory models agree. The auto cap's retry and the guard's bucket
growth: ``test_torch_shard_retry.py``."""

import dataclasses
import warnings

import jax
import numpy as np
import pytest

from shadow1_tpu import mem as mem_j
from shadow1_tpu.ckpt import run_chunked as run_chunked_j
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.shard.engine import ShardedEngine as ShardedJ
from shadow1_tpu.txn import OverflowGuard as GuardJ
from shadow1_tpu_torch import mem
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import MS
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.shard.launch import RankGroup
from tests import torch_shard_ranks as ranks
from tests.test_torch_fidelity import jax_experiment


def phold_exp(init_events=4, n=64, end=50 * MS):
    return ct.single_vertex_experiment(
        n_hosts=n, seed=7, end_time=end, latency_ns=1 * MS, model="phold",
        model_cfg={"mean_delay_ns": float(2 * MS),
                   "init_events": init_events})


@pytest.fixture(scope="module")
def group():
    with RankGroup(2, "gloo", "cpu", deadline_s=300) as g:
        yield g


def jax_run(exp, params: dict, d: int, windows=None, check_x2x=True):
    eng = ShardedJ(jax_experiment(exp), EngineParamsJ(**params),
                   devices=jax.devices()[:d])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        st = eng.run(n_windows=windows, check_x2x=check_x2x)
    return eng, ShardedJ.metrics_dict(st)


def test_tiny_bucket_counts_what_the_reference_counts(group):
    """x2x_cap=1 with check_x2x=False: every dropped packet is counted,
    the demanded fill is recorded, and every metric equals the
    reference's; the accounting identity closes."""
    exp = phold_exp()
    got = group.call(ranks.run_sharded, exp, EngineParamsT(x2x_cap=1), None,
                     None, False)
    _, m = jax_run(exp, dict(x2x_cap=1), 2, check_x2x=False)
    tm = got["metrics"]
    assert tm == m
    assert tm["x2x_overflow"] > 0 and tm["x2x_max_fill"] > 1
    assert tm["pkts_sent"] == (tm["pkts_lost"] + tm["pkts_delivered"]
                               + tm["x2x_overflow"] + tm["ev_overflow"])


def test_explicit_cap_that_overflows_raises(group):
    got = group.call(ranks.run_sharded, phold_exp(),
                     EngineParamsT(x2x_cap=1), None, None, True, True)
    assert "x2x_cap" in got["raised"] and "dropped" in got["raised"]


def _jax_guarded(exp, params: dict, d: int, windows: int, chunk: int):
    p = EngineParamsJ(**params)
    eng = ShardedJ(jax_experiment(exp), p, devices=jax.devices()[:d])
    guard = GuardJ(eng, make_engine=lambda q: ShardedJ(
        jax_experiment(exp), q, devices=jax.devices()[:d]), mode="retry")
    st = run_chunked_j(eng, n_windows=windows, chunk=chunk, guard=guard)
    return ShardedJ.metrics_dict(st), guard


def test_guard_grows_ev_cap_on_every_rank(group):
    """An ev_cap overflow on any rank is global (the metrics are reduced):
    every rank grows, migrates its columns and replays together; the
    committed run equals the JAX guard's over 2 devices."""
    exp = ct.single_vertex_experiment(
        n_hosts=8, seed=5, end_time=40 * MS, latency_ns=1 * MS,
        model="phold",
        model_cfg={"mean_delay_ns": float(2 * MS), "init_events": 6})
    params = dict(ev_cap=8, on_overflow="retry", metrics_ring=10,
                  state_digest=1)
    got = group.call(ranks.guarded, exp, EngineParamsT(**params), 40, 10)
    m, guard = _jax_guarded(exp, params, 2, 40, 10)
    assert guard.chunk_retries >= 1
    assert got["metrics"] == m and got["resizes"] == guard.resizes


@pytest.mark.parametrize("name", ["rung1_filexfer", "churn_filexfer",
                                  "sweep_phold"])
def test_estimate_per_rank_matches_reference(name):
    """mem.estimate(n_dev=2) against the reference's: the host-axis planes
    divide across the ranks, the metrics and the ring do not, the record
    carries n_dev, and both price an exchange peak. The deliberate
    differences (ROADMAP Queue C): the port divides the CPU clock (the
    ``scalars`` plane) too, and prices the exchange's send and receive
    buffers at the full bucket."""
    from shadow1_tpu.config.experiment import load_experiment as load_j
    from shadow1_tpu_torch.config.experiment import load_experiment as load_t

    path = f"configs/{name}.yaml"
    exp_j, par_j, _ = load_j(path)
    exp_t, par_t, _ = load_t(path)
    ej = mem_j.estimate(exp_j, par_j, n_dev=2)
    et = mem.estimate(exp_t, par_t, n_dev=2)
    for k in ("evbuf", "outbox", "model", "metrics", "telem", "init_model"):
        assert et.planes.get(k) == ej.planes.get(k), k
    rj, rt = ej.record(None), et.record(None)
    assert rt["n_dev"] == rj["n_dev"] == 2 and rt["n_exp"] == rj["n_exp"]
    assert "x2x" in rt["peaks"] and "x2x" in rj["peaks"]
    one = mem.estimate(exp_t, par_t)
    assert one.record(None)["n_dev"] == 1 and "x2x" not in one.peaks
    assert et.planes["evbuf"] == -(-one.planes["evbuf"] // 2)
    assert et.state_bytes < one.state_bytes


def test_downshift_prices_one_rank():
    """A budget that one device's estimate exceeds but one rank's of two
    fits needs no downshift at n_dev=2."""
    exp = phold_exp(n=4096)
    params = EngineParamsT(ev_cap=64, on_overflow="retry")
    one, two = mem.estimate(exp, params), mem.estimate(exp, params, n_dev=2)
    budget = (one.peak_bytes + two.peak_bytes) // 2
    assert two.peak_bytes <= budget < one.peak_bytes
    p2, actions = mem.downshift(exp, params, budget, n_dev=2)
    assert actions == [] and p2 == params
    p1, actions = mem.downshift(exp, params, budget)
    assert actions and actions[0]["action"] == "drop_rollback"
    assert dataclasses.replace(p1, on_overflow="retry") == params

"""The sharded engine on gloo CPU ranks against the JAX ``ShardedEngine``
at the same device count (``tests/conftest.py`` gives JAX 8 virtual
devices): every metric (``rounds`` and ``round_cap_hits``, the per-shard
sums, included), the summary, the ring rows and the gathered state, leaf
by leaf. Also the launcher's guarantees: a window in which a rank has no
traffic finishes, a collective that one rank never joins fails within the
group's timeout, rank 0's writes may outlast that timeout, and a rank's
exception reaches the caller.

One spawned group of 2 ranks serves every 2-rank case of this file."""

import time

import jax
import numpy as np
import pytest

from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.shard.engine import ShardedEngine as ShardedJ
from shadow1_tpu.telemetry.ring import drain_ring as ring_j
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import MS, SEC
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.shard.launch import RankError, RankGroup, launch
from tests import torch_shard_ranks as ranks
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import assert_same_leaves


def phold_exp():
    return ct.single_vertex_experiment(
        n_hosts=64, seed=7, end_time=50 * MS, latency_ns=1 * MS,
        model="phold",
        model_cfg={"mean_delay_ns": float(2 * MS), "init_events": 2})


def filexfer_exp(n=8, end_s=5, loss=0.01, idle_from=None):
    """The reference's convergent filexfer (every client → host 0). With
    ``idle_from``, hosts from there on are idle servers: no event ever
    reaches them, so a rank that holds only such hosts has no traffic."""
    role = np.full(n, 1, np.int64)
    role[0] = 0
    if idle_from is not None:
        role[idle_from:] = 0
    return ct.single_vertex_experiment(
        n_hosts=n, seed=3, end_time=end_s * SEC, latency_ns=10 * MS,
        loss=loss, bw_bits=10**7, model="net",
        model_cfg={"app": "filexfer", "role": role,
                   "server": np.zeros(n, np.int64),
                   "flow_bytes": np.full(n, 30_000, np.int64),
                   "start_time": np.full(n, 1 * MS, np.int64),
                   "flow_count": np.where(role == 1, 1, 0)})


@pytest.fixture(scope="module")
def group():
    with RankGroup(2, "gloo", "cpu", deadline_s=300) as g:
        yield g


def jax_sharded(exp, params: dict, d: int, windows=None):
    eng = ShardedJ(jax_experiment(exp), EngineParamsJ(**params),
                   devices=jax.devices()[:d])
    st = eng.run(n_windows=windows)
    return (ShardedJ.metrics_dict(st),
            jax.tree.map(np.asarray, eng.model_summary(st)),
            jax.tree.map(np.asarray, st), st)


def assert_same_as_jax(got, ref, window):
    m, summ, end, st = ref
    assert got["metrics"] == m
    assert set(got["summary"]) == set(summ)
    for k, v in summ.items():
        np.testing.assert_array_equal(got["summary"][k], v, err_msg=k)
    assert_same_leaves(end, got["end"])
    if st.telem is not None:
        assert got["ring"] == ring_j(st, window)


@pytest.mark.parametrize("d", [2, 4])
def test_phold_matches_jax_sharded(d, group):
    """PHOLD at 2 and 4 ranks: metrics (rounds included), summary and the
    gathered state equal the JAX ShardedEngine's over as many devices."""
    exp = phold_exp()
    if d == 2:
        got = group.call(ranks.run_sharded, exp, EngineParamsT(), None)
    else:
        got = launch(ranks.run_sharded, d, exp, EngineParamsT(), None,
                     deadline_s=300)
    assert got["metrics"]["events"] > 500
    assert got["metrics"]["x2x_overflow"] == 0
    # The per-shard rounds: each rank's own loop, summed.
    assert min(got["rank_rounds"]) > 0
    assert sum(got["rank_rounds"]) == got["metrics"]["rounds"]
    assert_same_as_jax(got, jax_sharded(exp, {}, d), exp.window)


def test_jax_sharded_state_carried_into_the_ranks(group):
    """The JAX ShardedEngine's state after 20 windows (numpy leaves),
    placed on 2 port ranks (``convert.sharded_from_numpy``) and run on,
    ends leaf for leaf where the JAX run ends."""
    exp = phold_exp()
    eng = ShardedJ(jax_experiment(exp), EngineParamsJ(),
                   devices=jax.devices()[:2])
    mid = eng.run(n_windows=20)
    end = eng.run(mid, n_windows=30)
    got = group.call(ranks.carried, exp, EngineParamsT(),
                     jax.tree.map(np.asarray, mid), 30)
    assert got["metrics"] == ShardedJ.metrics_dict(end)
    assert_same_leaves(jax.tree.map(np.asarray, end), got["end"])


def test_filexfer_digest_matches_jax_sharded(group):
    """The convergent filexfer with the digest ring on, 2 ranks: the ring
    rows (digest words included) and the per-shard rounds too."""
    exp = filexfer_exp()
    params = dict(ev_cap=256, metrics_ring=60, state_digest=1)
    got = group.call(ranks.run_sharded, exp, EngineParamsT(**params), 60)
    assert got["metrics"]["pkts_delivered"] > 100
    assert_same_as_jax(got, jax_sharded(exp, params, 2, 60), exp.window)


def test_rank_without_traffic_finishes(group):
    """Hosts 4-7 (rank 1's block) are idle servers: rank 1 pops nothing in
    any window, yet it joins every window's collectives, and the run
    equals the JAX ShardedEngine's."""
    exp = filexfer_exp(idle_from=4, end_s=1)
    params = dict(ev_cap=256, metrics_ring=100, state_digest=1)
    got = group.call(ranks.run_sharded, exp, EngineParamsT(**params), None)
    ref = jax_sharded(exp, params, 2)
    assert int(np.asarray(got["summary"]["rx_bytes"])[4:].sum()) == 0
    assert got["metrics"]["events"] > 0
    assert_same_as_jax(got, ref, exp.window)


def test_mismatched_collective_fails_within_timeout():
    """A collective that rank 1 never joins fails at the group's timeout;
    the launcher kills the ranks and reports it — it never hangs."""
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 0 raised"):
        launch(ranks.mismatched, 2, timeout_s=3, deadline_s=60)
    assert time.monotonic() - t0 < 45


def test_rank0_write_outlasting_the_group_timeout(group, tmp_path):
    """Rank 0's mid-run snapshot write takes longer than the group's
    timeout (3 s here) while rank 1 waits for it at ``on_root``'s barrier
    before its next window's exchange: the run still ends, saves at every
    chunk, and equals a run without snapshots."""
    exp = phold_exp()
    got = launch(ranks.slow_snapshot, 2, exp, EngineParamsT(), 4,
                 str(tmp_path / "snap.pt"), 5.0, timeout_s=3,
                 deadline_s=120)
    assert got["saved"] == [2, 4]
    ref = group.call(ranks.run_sharded, exp, EngineParamsT(), 4)
    assert got["metrics"] == ref["metrics"]


def test_rank_exception_reaches_the_caller():
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        launch(ranks.fail_on_rank1, 2, deadline_s=60)


def test_nccl_with_two_ranks_on_one_card_is_refused():
    """NCCL puts one rank on one card: the refusal names gloo, and nothing
    is redirected."""
    from shadow1_tpu_torch.shard.launch import check_backend

    with pytest.raises(ValueError, match="gloo"):
        check_backend("nccl", "cpu", 1)
    import torch

    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="use backend 'gloo'"):
            check_backend("nccl", "cuda", 2)


def test_world_of_one_runs_in_process():
    """A world of one needs no process: the group runs in the caller."""
    with RankGroup(1, "gloo", "cpu") as g:
        assert g.call(ranks.world_info) == (0, 1, "gloo")


def test_engine_needs_a_process_group():
    from shadow1_tpu_torch.shard.engine import ShardedEngine

    with pytest.raises(RuntimeError, match="process group"):
        ShardedEngine(phold_exp(), EngineParamsT(), device="cpu")

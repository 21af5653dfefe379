"""The exchange bucket's recovery on the reference's convergent case (every
client → host 0, 4 hosts on each of 8 gloo CPU ranks): an auto cap that
overflows reruns at the full cap and equals the JAX ``ShardedEngine``
over 8 devices, and ``txn.OverflowGuard`` grows the bucket through
``grow_x2x`` and commits the JAX guard's run; ``mem.estimate`` prices
the input clone that the auto cap's retry keeps. One spawned group of 8
ranks serves every case."""

import numpy as np
import pytest

from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import MS, SEC
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.shard.launch import RankGroup
from tests import torch_shard_ranks as ranks
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_shard_x2x import _jax_guarded, jax_run


def flagship_exp(n=32, end=1 * SEC):
    """The reference's convergent filexfer (every client → host 0)."""
    role = np.full(n, 1, np.int64)
    role[0] = 0
    return ct.single_vertex_experiment(
        n_hosts=n, seed=42, end_time=end, latency_ns=10 * MS, loss=0.01,
        bw_bits=10**7, model="net",
        model_cfg={"app": "filexfer", "role": role,
                   "server": np.zeros(n, np.int64),
                   "flow_bytes": np.full(n, 30_000, np.int64),
                   "start_time": np.full(n, 1 * MS, np.int64),
                   "flow_count": np.where(role == 1, 1, 0)})


FLAGSHIP = dict(ev_cap=64, outbox_cap=16, sockets_per_host=4)


@pytest.fixture(scope="module")
def group8():
    with RankGroup(8, "gloo", "cpu", deadline_s=300) as g:
        yield g


def test_auto_cap_retries_and_equals_the_reference(group8):
    """Convergent traffic overflows the uniform auto cap at 8 ranks (4
    hosts each, the reference's case); run() reruns the input at the full
    cap, and every metric equals the JAX ShardedEngine's (which retries
    alike) and, but for the per-shard counters, the solo engine's."""
    exp = flagship_exp()
    got = group8.call(ranks.run_sharded, exp, EngineParamsT(**FLAGSHIP), 4)
    cap0, cap, full = got["x2x_cap"]
    assert cap == full > cap0
    eng, m = jax_run(exp, FLAGSHIP, 8, windows=4)
    assert eng._x2x_cap == cap and got["metrics"] == m
    solo = EngineJ.metrics_dict(EngineJ(jax_experiment(exp),
                                        EngineParamsJ(**FLAGSHIP)).run(
                                            n_windows=4))
    for k in ("events", "pkts_sent", "pkts_delivered", "pkts_lost",
              "ev_overflow", "ob_overflow", "x2x_overflow", "tcp_rto"):
        assert m[k] == solo[k], k


def test_guard_grows_the_bucket_like_the_reference(group8):
    """on_overflow retry: the chunk whose x2x_overflow grew is replayed at
    the full bucket (``grow_x2x``), and the committed run equals the JAX
    guard's."""
    exp = flagship_exp()
    params = dict(FLAGSHIP, on_overflow="retry")
    got = group8.call(ranks.guarded, exp, EngineParamsT(**params), 4, 2)
    m, guard = _jax_guarded(exp, params, 8, 4, 2)
    assert got["metrics"] == m
    assert got["resizes"] == guard.resizes
    assert any("x2x_cap" in r for r in got["resizes"])
    assert got["x2x_cap"] == got["full_cap"]


@pytest.mark.parametrize("x2x_cap", [0, 64])
def test_estimate_prices_the_retry_clone(group8, x2x_cap):
    """At 8 ranks an auto-sized bucket lies below the full one, so
    ``ShardedEngine.run`` keeps a clone of its input for the retry:
    ``mem.estimate(n_dev=8)`` prices it as the rollback peak, within the
    estimator audit's tolerance of the clone's bytes (the planes divide
    the event buffer's two replicated scalars across the ranks, as the
    reference's model does: 10 bytes here). An explicit cap takes no
    clone and prices none."""
    from shadow1_tpu_torch import mem

    exp = flagship_exp()
    params = EngineParamsT(**FLAGSHIP, x2x_cap=x2x_cap)
    got = group8.call(ranks.clone_priced, exp, params, 1)
    if x2x_cap:
        assert got["clones"] == [] and got["rollback"] == 0
    else:
        (clone,) = got["clones"]
        assert got["rollback"] > 0
        assert abs(clone - got["rollback"]) <= (mem.AUDIT_TOLERANCE
                                                * got["rollback"])

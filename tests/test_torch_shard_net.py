"""The sharded engine on 2 gloo CPU ranks against the JAX package's solo
engine on the net model: RED AQM on a filexfer, a Tor net with
``compact_cap`` (the per-rank bucket), and the fidelity tiles with
``faults:`` (the restart capture, dead destinations), the flow probes,
the link accumulator and the digest words on. Every metric but the
per-shard ones, the summary, the ring rows (their per-shard columns
aside) and the flow and link records equal the reference's. (The per-shard
sums and the gathered state, leaf by leaf, equal the JAX
``ShardedEngine``'s: ``test_torch_shard.py``. The JAX package's own
sharded and solo states may hold the same events in other slots.)"""

import jax
import numpy as np
import pytest

from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.telemetry.links import drain_links as links_j
from shadow1_tpu.telemetry.probes import drain_probes as probes_j
from shadow1_tpu.telemetry.ring import drain_ring as ring_j
from shadow1_tpu_torch.consts import SEC
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.shard.engine import local_compact_cap
from shadow1_tpu_torch.shard.launch import RankGroup
from tests import torch_shard_ranks as ranks
from tests.test_tor_parity import tor_exp
from tests.test_torch_ckpt import OBS_PARAMS, obs_experiment
from tests.test_torch_fidelity import _red, jax_experiment
from tests.test_torch_tgen import port_experiment

# Counted per rank, so summed over the ranks: the round loop's counters.
PER_SHARD = {"rounds", "round_cap_hits", "x2x_max_fill", "compact_max_fill",
             "fires_pkt", "fires_deliver", "fires_timer", "fires_txr",
             "fires_app"}


def _strip(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in PER_SHARD}


@pytest.fixture(scope="module")
def group():
    with RankGroup(2, "gloo", "cpu", deadline_s=300) as g:
        yield g


# name -> (experiment, params, windows)
CASES = {
    "red_aqm": (lambda: _red(end=2 * SEC), dict(ev_cap=256, metrics_ring=200,
                                                state_digest=1), 200),
    "tor_compact": (lambda: port_experiment(tor_exp(
        end=100 * 10_000_000, n_circuits=1, n_streams=1, mean_cells=10.0)),
        dict(ev_cap=256, sockets_per_host=32, compact_cap=8,
             metrics_ring=100, state_digest=1), 100),
    "faults_probes_links": (obs_experiment, OBS_PARAMS, OBS_PARAMS[
        "metrics_ring"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_net_matches_jax_solo(name, group):
    make, params, windows = CASES[name]
    exp = make()
    got = group.call(ranks.run_sharded, exp, EngineParamsT(**params),
                     windows)
    eng = EngineJ(jax_experiment(exp), EngineParamsJ(**params))
    st = eng.run(n_windows=windows)
    m = EngineJ.metrics_dict(st)
    assert _strip(got["metrics"]) == _strip(m)
    assert got["metrics"]["x2x_overflow"] == 0
    for k, v in jax.tree.map(np.asarray, eng.model_summary(st)).items():
        np.testing.assert_array_equal(got["summary"][k], v, err_msg=k)
    assert [_strip(r) for r in got["ring"]] == [
        _strip(r) for r in ring_j(st, exp.window)]
    assert got["flow"] == probes_j(st, exp.window, params.get("probes", ()))
    assert got["link"] == links_j(st, exp.window)
    if name == "red_aqm":
        assert m["nic_aqm_drops"] > 0
    if name == "tor_compact":
        # Rank 0's bucket (8 of its 12 columns) took both branches.
        cw = got["compact_windows"]
        assert cw["compact"] > 0 and cw["full"] > 0, cw
    if name == "faults_probes_links":
        assert m["host_restarts"] > 0 and m["down_pkts"] > 0
        assert got["flow"] and got["link"]


def test_per_rank_compaction_bucket():
    """compact_cap is sized against the global active set: each rank gets
    ceil(cap / D) rounded up to a tile (8 below 128, else 128), at most
    its own columns."""
    assert local_compact_cap(0, 2, 100) == 0
    assert local_compact_cap(8, 2, 12) == 8
    assert local_compact_cap(1280, 1, 10_000) == 1280
    assert local_compact_cap(1280, 4, 2_500) == 384
    assert local_compact_cap(300, 2, 100) == 100

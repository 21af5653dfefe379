"""The port's Bitcoin app against the JAX package, on the CPU.

``btc_exp`` of ``tests/test_bitcoin_parity.py`` (16 hosts on a 4-regular
ring-chord graph, 6 transactions from 200 ms every 150 ms, 10 ms paths):
the flood, the flood under 2 % loss and the flood with a compaction
bucket narrower than the host count. The port's ``Engine(device="cpu")``
must equal the JAX ``Engine`` bit for bit — every ``Metrics`` field,
every summary array (who saw which tx, and when), every ring row (the
per-window digest words included) and every state leaf at a mid-run
window and at the end — and every node must have seen every tx, over the
reference's whole horizons.

``configs/rung5_bitcoin5k.yaml`` compiles to the same arrays in both
packages, and ``bitcoin_experiment`` (the card golden's builder) equals
that compile.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import yaml

from shadow1_tpu.config import experiment as xj
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config import experiment as xt
from tests.test_bitcoin_parity import btc_exp
from tests.test_torch_tgen import (  # noqa: F401  (fixture)
    _one_thread,
    assert_port_matches,
    jax_reference,
    port_experiment,
)

ROOT = Path(__file__).resolve().parents[1]
MS, SEC = 10**6, 10**9

# name -> (btc_exp arguments, engine params); each runs its whole horizon
# (5 s; 8 s under loss) of 10 ms windows, held mid-run at a third of it.
CASES = {
    "flood": (dict(), dict(ev_cap=256)),
    "lossy": (dict(seed=2, loss=0.02, end=8 * SEC), dict(ev_cap=256)),
    "compacted": (dict(), dict(ev_cap=256, compact_cap=8)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_bitcoin_matches_jax(name, monkeypatch):
    from shadow1_tpu_torch.core import compact

    monkeypatch.setattr(compact, "WINDOWS", {"compact": 0, "full": 0})
    kw, params = CASES[name]
    exp = btc_exp(**kw)
    windows = exp.end_time // exp.window
    ref = jax_reference(exp, params, windows, windows // 3)
    mt, summ = assert_port_matches(ref, port_experiment(btc_exp(**kw)),
                                   params, windows, windows // 3)
    assert summ["reach"].tolist() == [16] * 6      # the flood is complete
    assert int(summ["total_tx_rx"]) == 16 * 6 - 6  # one payload per node
    if name == "lossy":
        assert mt["pkts_lost"] > 0
    if name == "compacted":
        assert compact.WINDOWS["compact"] > 0 and compact.WINDOWS["full"] > 0


def test_rung5_config_compiles_the_same():
    """rung5_bitcoin5k.yaml: the ring-chord peers, the tx origins (drawn
    from the seed) and times, every topology and per-host array and the
    engine params are the JAX package's; the in-code builder gives the
    same arrays."""
    with open(ROOT / "configs" / "rung5_bitcoin5k.yaml") as f:
        doc = yaml.safe_load(f)
    exp_j, par_j, _ = xj.build_experiment(copy.deepcopy(doc))
    exp_t, par_t, _ = xt.build_experiment(copy.deepcopy(doc))
    assert par_t.__dict__ == par_j.__dict__
    assert set(exp_t.model_cfg) == set(exp_j.model_cfg)
    for k, v in exp_j.model_cfg.items():
        w = exp_t.model_cfg[k]
        if isinstance(v, np.ndarray):
            assert w.dtype == v.dtype, k
            np.testing.assert_array_equal(w, v, err_msg=k)
        else:
            assert w == v, k
    arrays = ct.experiment_arrays(exp_t)
    assert arrays == ct.experiment_arrays(port_experiment(exp_j))
    built = ct.bitcoin_experiment(
        5000, 55, 60 * SEC, latency_ns=50 * MS, bw_bits=50_000_000, k=8,
        n_tx=200, tx_start=2 * SEC, tx_interval=250 * MS)
    assert ct.experiment_arrays(built) == arrays

"""The port's Tor app against the JAX package, on the CPU.

``tor_exp`` of ``tests/test_tor_parity.py`` (8 weighted relays, 2
dirauths, 12 clients, 2 idle hosts on 10 ms paths) with one circuit and
one stream per client, cut to 200 windows: every client bootstraps,
builds its telescoped circuit, streams its cells and finishes. The port's
``Engine(device="cpu")`` must equal the JAX ``Engine`` bit for bit (every
``Metrics`` field, summary array, ring row with its digest words, and
state leaf at windows 60 and 200), also from a JAX state carried across
at window 60. The weighted relay pick and the stream-size draw are held
to the reference's on random bits, the edges included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import rng as rng_j
from shadow1_tpu.apps import tor as tor_j
from shadow1_tpu_torch.apps import tor as tor_t
from tests.test_tor_parity import tor_exp
from tests.test_torch_tgen import (
    assert_carried,
    assert_port_matches,
    jax_reference,
    port_experiment,
)

WINDOWS, MID = 200, 60
PARAMS = dict(ev_cap=256, sockets_per_host=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp():
    return tor_exp(end=WINDOWS * 10_000_000, n_circuits=1, n_streams=1,
                   mean_cells=10.0)


@pytest.fixture(scope="module")
def jax_run():
    return jax_reference(_exp(), PARAMS, WINDOWS, MID)


def test_tor_matches_jax(jax_run):
    mt, summ = assert_port_matches(jax_run, port_experiment(_exp()), PARAMS,
                                   WINDOWS, MID)
    assert int(summ["clients_done"]) == 12
    assert int(summ["total_streams_done"]) == 12
    assert int(summ["total_cells_rx"]) > 0 and int(summ["total_cells_fwd"]) > 0
    assert int(summ["total_ct_overflow"]) == 0
    assert mt["fires_app"] > 0


def test_tor_state_carried_from_jax(jax_run):
    assert_carried(jax_run, port_experiment(_exp()), PARAMS, WINDOWS, MID)


def _bits(g, n):
    b = g.integers(0, 2**32, n, dtype=np.int64)
    b[:32] = 2**32 - 1
    b[32:64] = 0
    return b


@pytest.mark.parametrize("n_members,max_w", [(1, 7), (9, 300),
                                             (300, 7_000_000)])
def test_pick_weighted_matches_jax(n_members, max_w):
    """Relay picks on random bits (all-ones and zero included) over random
    weight tables, up to a total weight near 2**31."""
    g = np.random.default_rng(n_members)
    ids = np.sort(g.choice(10_000, n_members, replace=False)).astype(np.int32)
    w = g.integers(1, max_w + 1, n_members).astype(np.int64)
    cum = np.cumsum(w)
    assert cum[-1] < 2**31
    bits = _bits(g, 8192)
    want = np.asarray(tor_j._pick_weighted(jnp.asarray(bits, jnp.uint32),
                                           ids, cum))
    got = tor_t._pick_weighted(torch.from_numpy(bits), torch.from_numpy(ids),
                               torch.from_numpy(cum)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if n_members > 1:
        assert len(np.unique(got)) > 1


def test_stream_cells_draw_matches_jax():
    """The stream's cell count: the exponential draw clipped to
    [1, cells_max], at both clip edges, for cells_max 120 and 1."""
    g = np.random.default_rng(3)
    bits = _bits(g, 8192)
    mean = g.uniform(0.0, 200.0, len(bits)).astype(np.float32)
    mean[::5] = g.uniform(0.0, 1.5, len(mean[::5]))
    for cells_max in (120, 1):
        want = np.asarray(jnp.clip(
            rng_j.exponential_ns(jnp.asarray(bits, jnp.uint32),
                                 jnp.asarray(mean)), 1, cells_max
        ).astype(jnp.int32))
        ctx = type("Ctx", (), {"model_cfg": {"cells_max": cells_max}})
        got = tor_t.stream_cells(ctx, {"cfg_mean_cells": torch.from_numpy(mean)},
                                 torch.from_numpy(bits)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (got == 1).any() and (got == cells_max).any()


def test_tables_stay_out_of_model_cfg():
    """The path tables equal the reference's, with each kind's total
    weight beside them, and are never written into ``model_cfg`` (which
    must stay arrays and scalars)."""
    cfg = port_experiment(_exp()).model_cfg
    keys = set(cfg)
    t = tor_t.tables(cfg, torch.device("cpu"))
    assert set(cfg) == keys
    want = tor_j.tables(dict(cfg))
    assert set(t) == set(want) | {f"{k}_total"
                                  for k in ("guard", "exit", "relay")}
    for k, v in want.items():
        np.testing.assert_array_equal(t[k].numpy(), v, err_msg=k)
        if k.endswith("_cum"):
            assert t[k.replace("_cum", "_total")] == int(v[-1])


@pytest.mark.slow
def test_tor_full_matrix_matches_jax():
    """The reference's full Tor matrix (two circuits of two streams per
    client, the 30 s horizon) through both engines."""
    exp = tor_exp()
    windows = exp.end_time // exp.window
    ref = jax_reference(exp, PARAMS, windows, windows // 3)
    _, summ = assert_port_matches(ref, port_experiment(tor_exp()), PARAMS,
                                  windows, windows // 3)
    assert int(summ["clients_done"]) == 12
    assert int(summ["total_streams_done"]) == 12 * 2 * 2


@pytest.mark.slow
def test_rung3_compacted_matches_jax():
    """configs/rung3_tor1k.yaml (1,000 hosts, compact_cap 384) for 100
    windows (3 s): bootstrap, circuits and the first streams."""
    import copy
    from pathlib import Path

    import yaml

    from shadow1_tpu.config import experiment as xj

    cfg = Path(__file__).resolve().parents[1] / "configs" / "rung3_tor1k.yaml"
    with open(cfg) as f:
        doc = yaml.safe_load(f)
    exp, par, _ = xj.build_experiment(copy.deepcopy(doc),
                                      base_dir=str(cfg.parent))
    params = {f: getattr(par, f) for f in ("ev_cap", "sockets_per_host",
                                           "msgq_cap", "max_rounds",
                                           "compact_cap")}
    ref = jax_reference(exp, params, 100, 40)
    _, summ = assert_port_matches(ref, port_experiment(exp), params, 100, 40)
    assert int(summ["total_cells_rx"]) > 0

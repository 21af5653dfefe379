"""The port's tgen app against the JAX package, on the CPU.

``tgen_exp`` of ``tests/test_tgen_parity.py`` (12 all-active hosts, two
streams each, 10 ms paths): lossless (300 windows, every stream done),
under 2 % loss (250 windows, retransmits) and with fixed stream sizes
(200 windows). The port's ``Engine(device="cpu")`` must equal the JAX
``Engine`` bit for bit: every ``Metrics`` field, every summary array,
every ring row (the per-window digest words included) and every state
leaf, at a mid-run window and at the end; a JAX state taken mid-run and
carried across with ``convert.py`` goes on bit-exactly. The stream-size
draw is held to the reference's on random bits, at the clip edges.

The helpers here (``jax_reference``, ``port_experiment``,
``assert_port_matches``, ``assert_carried``) serve the other app files.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import rng as rng_j
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.telemetry.ring import drain_ring as drain_j
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.apps import tgen as tgen_t
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.telemetry.ring import drain_ring as drain_t
from tests.test_tgen_parity import tgen_exp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU path runs thousands of tiny tensor ops per round;
    one intra-op thread keeps them from fighting the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_experiment(exp):
    """The same experiment as the port's CompiledExperiment, with a model
    config dict of its own (the reference memoizes into its dict)."""
    out = ct.CompiledExperiment(**{
        f.name: getattr(exp, f.name)
        for f in dataclasses.fields(ct.CompiledExperiment)})
    out.model_cfg = {k: v for k, v in exp.model_cfg.items()
                     if not k.startswith("_")}
    return out


def ring_params(params: dict, windows: int) -> dict:
    return dict(params, metrics_ring=windows, state_digest=1)


def jax_reference(exp, params: dict, windows: int, mid: int):
    """The JAX engine: the states at windows ``mid`` and ``windows`` (numpy
    leaves), the ring rows, metrics and summary at the end."""
    eng = EngineJ(exp, EngineParamsJ(**ring_params(params, windows)))
    st_mid = eng.run(n_windows=mid)
    st_end = eng.run(st_mid, n_windows=windows - mid)
    return types.SimpleNamespace(
        mid=jax.tree.map(np.asarray, st_mid),
        end=jax.tree.map(np.asarray, st_end),
        rows=drain_j(st_end, exp.window),
        metrics=EngineJ.metrics_dict(st_end),
        summary=jax.tree.map(np.asarray, eng.model_summary(st_end)))


def assert_same_leaves(want, got):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    lg = jax.tree.leaves(got)
    assert len(flat) == len(lg)
    for (path, a), b in zip(flat, lg):
        path = jax.tree_util.keystr(path)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=path)


def assert_end_matches(ref, eng, st, window: int):
    """Metrics, summary, ring rows and every state leaf at the end."""
    mt = EngineT.metrics_dict(st)
    assert list(mt) == list(ref.metrics) and mt == ref.metrics
    for k in ("ev_overflow", "ob_overflow", "round_cap_hits"):
        assert mt[k] == 0, k
    summ = eng.model_summary(st)
    assert set(summ) == set(ref.summary)
    for k, v in ref.summary.items():
        assert summ[k].dtype == v.dtype, k
        np.testing.assert_array_equal(summ[k], v, err_msg=k)
    assert drain_t(st, window) == ref.rows
    assert_same_leaves(ref.end, convert.state_to_numpy(st))
    return mt, summ


def assert_port_matches(ref, exp, params: dict, windows: int, mid: int):
    """The port from init to ``windows``, held to ``ref`` at ``mid`` and at
    the end. Returns (metrics, summary)."""
    eng = EngineT(exp, EngineParamsT(**ring_params(params, windows)),
                  device="cpu")
    st = eng.run(n_windows=mid)
    assert_same_leaves(ref.mid, convert.state_to_numpy(st))
    st = eng.run(st, n_windows=windows - mid)
    return assert_end_matches(ref, eng, st, exp.window)


def assert_carried(ref, exp, params: dict, windows: int, mid: int):
    """The reference's state at ``mid``, carried into the port, goes on to
    the reference's end state."""
    eng = EngineT(exp, EngineParamsT(**ring_params(params, windows)),
                  device="cpu")
    st = eng.run(convert.state_from_numpy(ref.mid, "cpu"),
                 n_windows=windows - mid)
    assert_end_matches(ref, eng, st, exp.window)


def _fixed_exp():
    exp = tgen_exp(n_hosts=6, seed=4, streams=3, mean_bytes=15_000)
    exp.model_cfg["fixed_size"] = True
    return exp


# name -> (experiment, windows, mid); 10 ms windows.
CASES = {
    "lossless": (lambda: tgen_exp(), 300, 100),
    "lossy": (lambda: tgen_exp(seed=8, loss=0.02, mean_bytes=30_000), 250, 90),
    "fixed_size": (_fixed_exp, 200, 70),
}
PARAMS = dict(ev_cap=256)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name):
        if name not in cache:
            make, windows, mid = CASES[name]
            cache[name] = jax_reference(make(), PARAMS, windows, mid)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_tgen_matches_jax(jax_runs, name):
    make, windows, mid = CASES[name]
    ref = jax_runs(name)
    mt, summ = assert_port_matches(ref, port_experiment(make()), PARAMS,
                                   windows, mid)
    n_hosts = make().n_hosts
    streams = int(make().model_cfg["streams"][0])
    assert int(summ["total_streams_done"]) == n_hosts * streams
    assert mt["fires_app"] > 0 and mt["pops_deliver"] > 0
    if name == "lossy":
        assert mt["pkts_lost"] > 0 and mt["tcp_rto"] + mt["tcp_fast_rtx"] > 0
    if name == "fixed_size":
        assert int(summ["total_rx_bytes"]) == n_hosts * streams * 15_000


def test_tgen_state_carried_from_jax(jax_runs):
    make, windows, mid = CASES["lossy"]
    assert_carried(jax_runs("lossy"), port_experiment(make()), PARAMS,
                   windows, mid)


def test_stream_size_draw_matches_jax():
    """The stream-size draw on random bits and means, the clip edges
    included: all-ones bits (the longest draw, clipped to 2**30), zero
    bits, tiny means (clipped up to 1) and the 2**38 mean clamp."""
    g = np.random.default_rng(5)
    n = 4096
    bits = g.integers(0, 2**32, n, dtype=np.int64)
    bits[:64] = 2**32 - 1
    bits[64:128] = 0
    mean = g.uniform(0.0, 4e8, n).astype(np.float32)
    mean[::7] = g.uniform(0.0, 2.0, len(mean[::7]))
    mean[::11] = 3e11
    want = np.asarray(jnp.clip(
        rng_j.exponential_ns(jnp.asarray(bits, jnp.uint32),
                             jnp.asarray(mean)), 1, tgen_t.SIZE_MAX
    ).astype(jnp.int32))
    ctx = types.SimpleNamespace(model_cfg={})
    app = {"mean_bytes": torch.from_numpy(mean)}
    got = tgen_t.stream_size(ctx, app, torch.from_numpy(bits)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got == tgen_t.SIZE_MAX).any() and (got == 1).any()
    # fixed_size: the mean itself, as i32 (means that fit i32, as a
    # stream size must).
    ok = mean < 2**31
    app = {"mean_bytes": torch.from_numpy(mean[ok])}
    fixed = tgen_t.stream_size(types.SimpleNamespace(
        model_cfg={"fixed_size": True}), app, None).numpy()
    np.testing.assert_array_equal(fixed, np.maximum(np.asarray(
        jnp.asarray(mean[ok]).astype(jnp.int32)), 1))


@pytest.mark.slow
def test_tgen_lossy_full_horizon_matches_jax():
    """The reference's lossy mesh over its whole 60 s horizon."""
    exp = tgen_exp(seed=8, loss=0.02, mean_bytes=30_000, end=60 * 10**9)
    windows = exp.end_time // exp.window
    ref = jax_reference(exp, PARAMS, windows, windows // 2)
    _, summ = assert_port_matches(
        ref, port_experiment(tgen_exp(seed=8, loss=0.02, mean_bytes=30_000,
                                      end=60 * 10**9)),
        PARAMS, windows, windows // 2)
    assert int(summ["total_streams_done"]) == 12 * 2

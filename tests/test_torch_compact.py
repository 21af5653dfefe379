"""The port's active-host compaction (``core/compact.py``) against the JAX
package, on the CPU.

``compact_perm`` and the gather/scatter of the state tree on random active
masks — no host active, fewer than ``cap`` (padding lanes that clone the
last host), exactly ``cap``, more than ``cap`` — must equal the
reference's. Then a Tor run (``tor_exp``, 24 hosts, ``compact_cap`` 8) and
a tgen run (``tgen_exp``, 12 hosts, ``compact_cap`` 6), each with windows
on both sides of the bucket, must equal the JAX engine with compaction —
every metric, summary array, ring row and state leaf — and the port with
compaction off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu.core import compact as cj
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core import compact as ct
from shadow1_tpu_torch.core.engine import Engine as EngineT
from tests.test_tgen_parity import tgen_exp
from tests.test_tor_parity import tor_exp
from tests.test_torch_tgen import (
    assert_port_matches,
    assert_same_leaves,
    jax_reference,
    port_experiment,
    ring_params,
)

H, CAP = 37, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask(g, n_active):
    m = np.zeros(H, bool)
    m[g.choice(H, n_active, replace=False)] = True
    return m


@pytest.mark.parametrize("n_active", [0, 3, CAP, 20])
def test_compact_perm_matches_jax(n_active):
    g = np.random.default_rng(n_active)
    for _ in range(4):
        m = _mask(g, n_active)
        want = [np.asarray(x) for x in cj.compact_perm(jnp.asarray(m), CAP)]
        got = [x.numpy() for x in ct.compact_perm(torch.from_numpy(m), CAP)]
        for w, x, name in zip(want, got, ("idx", "pos", "lane_pad")):
            assert x.dtype == w.dtype, name
            np.testing.assert_array_equal(x, w, err_msg=name)


def _tree(g, h):
    """A state-like tree: [C, H], [NP, C, H], [S, H], [H] leaves of several
    dtypes, and scalars (no host axis)."""
    return {
        "plane": g.integers(-2**31, 2**31, (5, h)).astype(np.int32),
        "payload": g.integers(-2**31, 2**31, (3, 5, h)).astype(np.int32),
        "flags": g.random((4, h)) < 0.5,
        "row": g.integers(0, 2**62, h).astype(np.int64),
        "epoch": np.array(g.integers(0, 2**40), np.int64),
        "nested": {"u32": np.array(7, np.int32), "sock": g.integers(0, 9, (2, h))
                   .astype(np.int32)},
    }


@pytest.mark.parametrize("n_active", [0, 3, CAP])
def test_gather_scatter_match_jax(n_active):
    """Gather to the bucket, a random update of every bucket lane (the
    round loop's writes), scatter back: bit-equal to the reference, with
    clone lanes left out of the scatter."""
    g = np.random.default_rng(100 + n_active)
    m = _mask(g, n_active)
    full = _tree(g, H)
    idx_j, pos_j, _ = cj.compact_perm(jnp.asarray(m), CAP)
    idx_t, pos_t, _ = ct.compact_perm(torch.from_numpy(m), CAP)
    full_j = jax.tree.map(jnp.asarray, full)
    full_t = jax.tree.map(torch.from_numpy, full)
    comp_j = cj._gather_tree(full_j, idx_j, H)
    comp_t = ct._gather_tree(full_t, idx_t, H)
    assert_same_leaves(jax.tree.map(np.asarray, comp_j),
                       jax.tree.map(lambda x: x.numpy(), comp_t))
    for x in jax.tree.leaves(comp_t):
        assert x.is_contiguous()
    new = _tree(g, CAP)
    back_j = cj._scatter_tree(full_j, jax.tree.map(jnp.asarray, new), pos_j,
                              jnp.asarray(m), H)
    back_t = ct._scatter_tree(full_t, jax.tree.map(torch.from_numpy, new),
                              pos_t, torch.from_numpy(m), H)
    assert_same_leaves(jax.tree.map(np.asarray, back_j),
                       jax.tree.map(lambda x: x.numpy(), back_t))


# name -> (experiment, params, windows, mid, compact_cap)
RUNS = {
    "tor": (lambda: tor_exp(end=100 * 10_000_000, n_circuits=1, n_streams=1,
                            mean_cells=10.0),
            dict(ev_cap=256, sockets_per_host=32), 100, 40, 8),
    "tgen": (lambda: tgen_exp(), dict(ev_cap=256), 100, 40, 6),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_compacted_run_matches_jax_and_plain(name):
    make, params, windows, mid, cap = RUNS[name]
    pc = dict(params, compact_cap=cap)
    ref = jax_reference(make(), pc, windows, mid)
    for k in ct.WINDOWS:
        ct.WINDOWS[k] = 0
    assert_port_matches(ref, port_experiment(make()), pc, windows, mid)
    # Both branches ran: windows above the bucket and windows in it.
    assert ct.WINDOWS["compact"] > 0 and ct.WINDOWS["full"] > 0, ct.WINDOWS
    plain = EngineT(port_experiment(make()),
                    EngineParamsT(**ring_params(params, windows)),
                    device="cpu").run(n_windows=windows)
    assert_same_leaves(ref.end, convert.state_to_numpy(plain))


def test_compact_ctx_keeps_global_ids():
    """The bucket view of the ctx gathers the per-host tables (global host
    ids, bandwidths), narrows n_hosts and keeps n_total global."""
    eng = EngineT(port_experiment(tgen_exp()), EngineParamsT(ev_cap=64),
                  device="cpu")
    idx = torch.tensor([2, 5, 11, 11], dtype=torch.int32)
    c = ct.compact_ctx(eng.ctx, idx, 4)
    assert c.n_hosts == 4 and c.n_total == eng.ctx.n_total == 12
    np.testing.assert_array_equal(c.hosts.numpy(), [2, 5, 11, 11])
    np.testing.assert_array_equal(c.bw_up.numpy(),
                                  eng.ctx.bw_up[idx.long()].numpy())
    assert dataclasses.replace(c, n_hosts=12).lat_vv is eng.ctx.lat_vv

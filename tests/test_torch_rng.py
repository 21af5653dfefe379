"""The port's counter-based RNG draws the JAX package's bits, exactly.

Inputs come from numpy with a seed and go through ``shadow1_tpu.rng`` (JAX,
u64 arithmetic) and ``shadow1_tpu_torch.rng`` (torch int64 with logical
shifts); every draw must be equal. Counters reach past 2**31 and hosts up
to 2**20, where an arithmetic shift or a sign-extended cast would show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import rng as rj
from shadow1_tpu_torch import rng as rt

SEEDS = [0, 1, 1234, 2**40 + 17]


def _inputs(seed: int, n: int = 4096):
    g = np.random.default_rng(seed)
    host = g.integers(0, 2**20, n, dtype=np.int64)
    ctr = g.integers(0, 2**34, n, dtype=np.int64)
    ctr[: n // 4] = g.integers(2**31 - 64, 2**31 + 64, n // 4)
    return host, ctr


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("purpose", [1, 2, 3, 7])
def test_bits_match(seed, purpose):
    host, ctr = _inputs(seed + purpose)
    kj = rj.base_key(seed)
    kt = rt.base_key(seed)
    assert int(np.asarray(kj)) == kt % 2**64
    bj = np.asarray(rj.bits(kj, purpose, jnp.asarray(host), jnp.asarray(ctr)))
    bt = rt.bits(kt, purpose, torch.from_numpy(host), torch.from_numpy(ctr))
    np.testing.assert_array_equal(bt.numpy(), bj.astype(np.int64))


@pytest.mark.parametrize("mean", [1.0, 2e6, 2.5e6 + 0.5, 1234.567, 2.0**40])
def test_exponential_ns_match(mean):
    """Means include a non-integer, a half (round-half-even) and one above
    the 2**38 clamp."""
    g = np.random.default_rng(int(mean) % 1000)
    b = g.integers(0, 2**32, 8192, dtype=np.int64)
    b[:4] = [0, 1, 2**32 - 1, 2**31]
    dj = np.asarray(rj.exponential_ns(jnp.asarray(b.astype(np.uint32)), mean))
    dt = rt.exponential_ns(torch.from_numpy(b), mean)
    np.testing.assert_array_equal(dt.numpy(), dj)


@pytest.mark.parametrize("n", [1, 64, 65536, 2**20, 2**31 + 5])
def test_randint_match(n):
    g = np.random.default_rng(n % 997)
    b = g.integers(0, 2**32, 8192, dtype=np.int64)
    b[:2] = [0, 2**32 - 1]
    rj_ = np.asarray(rj.randint(jnp.asarray(b.astype(np.uint32)), n))
    rt_ = rt.randint(torch.from_numpy(b), n)
    np.testing.assert_array_equal(rt_.numpy(), rj_)


@pytest.mark.parametrize("p", [0.0, 0.02, 0.05, 0.5, 1.0])
def test_uniform_lt_match(p):
    g = np.random.default_rng(int(p * 100))
    b = g.integers(0, 2**32, 8192, dtype=np.int64)
    thr = rt.prob_threshold(p)
    np.testing.assert_array_equal(thr, rj.prob_threshold(p))
    uj = np.asarray(rj.uniform_lt(jnp.asarray(b.astype(np.uint32)), thr))
    ut = rt.uniform_lt(torch.from_numpy(b), int(thr))
    np.testing.assert_array_equal(ut.numpy(), uj)

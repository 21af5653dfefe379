"""The numpy twins the port's oracle draws and digests with, against the
JAX package's numpy twins and the port's own torch functions.

Inputs come from numpy with a seed: hosts up to 2**20, counters past
2**31 and 2**32, u32 bits at 0, 1, 2**31 and 2**32 - 1, means with a
fraction, a half and one above the 2**38 clamp, digest fields at the i32
and i64 edges. ``shadow1_tpu_torch.rng``'s ``*_np`` functions and
``core/digest.py``'s host-side twins must equal ``shadow1_tpu``'s, draw
for draw and word for word, and the torch pipeline the port's engine
uses. Bit-exact throughout.
"""

import types

import numpy as np
import pytest
import torch

from shadow1_tpu import rng as rj
from shadow1_tpu.core import digest as dj
from shadow1_tpu_torch import rng as rt
from shadow1_tpu_torch.core import digest as dt

SEEDS = [0, 1, 1234, 2**40 + 17]
NP_ = 10


def _inputs(seed: int, n: int = 4096):
    g = np.random.default_rng(seed)
    host = g.integers(0, 2**20, n, dtype=np.int64)
    ctr = g.integers(0, 2**34, n, dtype=np.int64)
    ctr[: n // 4] = g.integers(2**31 - 64, 2**31 + 64, n // 4)
    return host, ctr


def _bits(seed: int, n: int = 8192) -> np.ndarray:
    b = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.int64)
    b[:4] = [0, 1, 2**32 - 1, 2**31]
    return b.astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_base_key_np(seed):
    k = rt.base_key_np(seed)
    assert type(k) is np.uint64 and k == rj.base_key_np(seed)
    assert int(k) == rt.base_key(seed) % 2**64


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("purpose", [1, 2, 3, 7])
def test_bits_np(seed, purpose):
    host, ctr = _inputs(seed + purpose)
    got = rt.bits_np(rt.base_key_np(seed), purpose, host, ctr)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(
        got, rj.bits_np(rj.base_key_np(seed), purpose, host, ctr))
    torch_bits = rt.bits(rt.base_key(seed), purpose, torch.from_numpy(host),
                         torch.from_numpy(ctr))
    np.testing.assert_array_equal(got.astype(np.int64), torch_bits.numpy())


def test_mix_np():
    z = np.random.default_rng(3).integers(0, 2**63, 4096, dtype=np.int64)
    z = z.astype(np.uint64) * np.uint64(3)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(rt._mix_np(z), rj._mix_np(z))


def test_uniform01():
    b = _bits(5)
    got = rt.uniform01(b)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(rj.uniform01(b)))


@pytest.mark.parametrize("mean", [1.0, 2e6, 2.5e6 + 0.5, 1234.567, 2.0**40])
def test_exponential_ns_np(mean):
    b = _bits(int(mean) % 1000)
    got = rt.exponential_ns_np(b, mean)
    np.testing.assert_array_equal(got, rj.exponential_ns_np(b, mean))
    np.testing.assert_array_equal(
        rt._neg_log1m_q32_np(b), rj._neg_log1m_q32_np(b))
    np.testing.assert_array_equal(
        got, rt.exponential_ns(torch.from_numpy(b.astype(np.int64)),
                               mean).numpy())


@pytest.mark.parametrize("n", [1, 64, 65536, 2**20, 2**31 + 5])
def test_randint_np(n):
    b = _bits(n % 997)
    got = rt.randint_np(b, n)
    np.testing.assert_array_equal(got, rj.randint_np(b, n))
    np.testing.assert_array_equal(
        got, rt.randint(torch.from_numpy(b.astype(np.int64)), n).numpy())


def test_log_table_constants():
    np.testing.assert_array_equal(rt._LOG_TBL_U64, rj._LOG_TBL_NP)
    assert rt._LN2_Q32 == rj._LN2_Q32 and rt._LOG_BITS == rj._LOG_BITS


# -- core/digest.py's host-side twins ----------------------------------------

EDGES32 = [-2**31, -1, 0, 1, 2**31 - 1]
EDGES64 = [0, 2**31, 2**32 - 1, 2**62, 2**63 - 1, -1]


def _payloads(g):
    """Payload tuples: empty, short, full, with i32 edges."""
    out = [(), (5,), tuple(EDGES32) + (7,) * 5]
    out += [tuple(int(x) for x in g.integers(-2**31, 2**31, k))
            for k in (3, NP_)]
    return out


def test_word_int_and_mix_int():
    g = np.random.default_rng(11)
    for _ in range(200):
        seed = int(g.integers(0, 2**63)) * 2 + 1
        fields = [int(x) for x in g.integers(-2**62, 2**62, 7)]
        assert dt.word_int(seed, fields) == dj.word_int(seed, fields)
        z = int(g.integers(0, 2**63)) * 2
        assert dt._mix_int(z) == dj._mix_int(z)


def test_event_and_packet_words():
    g = np.random.default_rng(12)
    for p in _payloads(g):
        for t, tb in zip(EDGES64, EDGES64[::-1]):
            host = int(g.integers(0, 2**20))
            kind = int(g.integers(1, 9))
            assert dt.event_word(host, t, tb, kind, p) \
                == dj.event_word(host, t, tb, kind, p)
            ctr = int(g.integers(0, 2**40))
            dst = int(g.integers(0, 2**20))
            assert dt.packet_word(host, dst, t, ctr, kind, p) \
                == dj.packet_word(host, dst, t, ctr, kind, p)


def test_event_word_is_the_plane_word():
    """The oracle's per-event word is the torch plane digest's element
    word: one occupied slot digests to it."""
    from shadow1_tpu_torch.core.events import evbuf_init, tb_split

    g = np.random.default_rng(13)
    buf = evbuf_init(1, 4, "cpu")
    t, tb, kind = 2**33 + 5, 2**40 + 3, 3
    p = tuple(int(x) for x in g.integers(-2**31, 2**31, NP_))
    buf.time_hi[0, 0], buf.time_lo[0, 0] = tb_split(torch.tensor(t))
    buf.tb_hi[0, 0], buf.tb_lo[0, 0] = tb_split(torch.tensor(tb))
    buf.kind[0, 0] = kind
    for i, v in enumerate(p):
        buf.p[i][0, 0] = v
    host = torch.tensor([7], dtype=torch.int32)
    assert int(dt.digest_evbuf(buf, host)) == dt.event_word(7, t, tb, kind, p)


def test_sock_word():
    g = np.random.default_rng(14)
    for _ in range(20):
        k = types.SimpleNamespace()
        for f in dt.TCP_FIELDS_I32:
            setattr(k, f, int(g.choice(EDGES32 + [int(g.integers(-9, 9))])))
        for f in dt.TCP_FIELDS_I64:
            setattr(k, f, int(g.choice(EDGES64)))
        for f in dt.TCP_FIELDS_BOOL:
            setattr(k, f, bool(g.integers(0, 2)))
        k.mq = [(int(g.integers(-2**31, 2**31)), int(g.integers(0, 2**31)))
                for _ in range(int(g.integers(0, 4)))]
        host, sock = int(g.integers(0, 2**20)), int(g.integers(0, 128))
        assert dt.sock_word(host, sock, k) == dj.sock_word(host, sock, k)


@pytest.mark.parametrize("n", [1, 17, 4096])
def test_plane_digests_np(n):
    g = np.random.default_rng(n)

    def col(dtype):
        if dtype == np.int32:
            return g.integers(-2**31, 2**31, n).astype(np.int32)
        return g.integers(-2**62, 2**62, n).astype(np.int64)

    nic = [col(np.int64) for _ in range(4)] + [col(np.int64)]
    assert dt.digest_nic_np(*nic) == dj.digest_nic_np(*nic)
    vec = [col(np.int64), col(np.int64), col(np.int32),
           (g.integers(0, 2, n) == 1)]
    assert dt.digest_rng_np(vec) == dj.digest_rng_np(vec)
    w = dt._words_np(dt.SEED_RNG, [np.arange(n)] + vec)
    np.testing.assert_array_equal(w, dj._words_np(dj.SEED_RNG,
                                                  [np.arange(n)] + vec))
    # The torch plane digests on the same columns.
    hosts = torch.arange(n, dtype=torch.int32)
    nic_t = types.SimpleNamespace(**{
        f: torch.from_numpy(a) for f, a in zip(
            ("tx_free", "rx_free", "tx_bytes", "rx_bytes", "aqm_ctr"), nic)})
    assert int(dt.digest_nic(nic_t, hosts)) == dt.digest_nic_np(*nic)
    assert int(dt.digest_rng(hosts, [torch.from_numpy(v) for v in vec])) \
        == dt.digest_rng_np(vec)


def test_digest_socks_np_is_the_sum_of_sock_words():
    """The oracle's vectorized tcp word equals the per-socket sum, with
    message-boundary entries."""
    g = np.random.default_rng(15)
    live = []
    for i in range(300):
        k = types.SimpleNamespace()
        for f in dt.TCP_FIELDS_I32:
            setattr(k, f, int(g.choice(EDGES32 + [int(g.integers(-9, 9))])))
        for f in dt.TCP_FIELDS_I64:
            setattr(k, f, int(g.choice(EDGES64)))
        for f in dt.TCP_FIELDS_BOOL:
            setattr(k, f, bool(g.integers(0, 2)))
        k.mq = [(int(g.integers(-2**31, 2**31)), int(g.integers(0, 2**31)))
                for _ in range(int(g.integers(0, 3)))]
        live.append((i // 7, i % 7, k))
    want = sum(dj.sock_word(h, s, k) for h, s, k in live)
    assert dt.digest_socks_np(live) == want and dt.digest_socks_np([]) == 0

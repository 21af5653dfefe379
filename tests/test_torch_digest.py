"""The port's state digests and telemetry ring against the JAX package.

Each ``digest_*`` word on random states made from a numpy seed — i32
fields negative and at the ±2**31 edges, i64 times up to I64_MAX, bool
planes — must equal ``shadow1_tpu.core.digest``'s; so must
``state_digests`` of a PHOLD and a net state, the ring rows that
``ring_record`` writes, and the ring schema. Bit-exact throughout.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu.core import digest as dj
from shadow1_tpu.core import engine as engine_j
from shadow1_tpu.core.events import EventBuf as EventBufJ
from shadow1_tpu.core.outbox import Outbox as OutboxJ
from shadow1_tpu.net.nic import NicState as NicStateJ
from shadow1_tpu.telemetry import registry as reg_j
from shadow1_tpu.telemetry import ring as ring_j
from shadow1_tpu.tcp import tcp as tcp_j
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.core import digest as dt
from shadow1_tpu_torch.core import engine as engine_t
from shadow1_tpu_torch.telemetry import registry as reg_t
from shadow1_tpu_torch.telemetry import ring as ring_t

NP = 10
EDGES32 = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                   np.int64)
EDGES64 = np.array([0, 1, 2**31, 2**32 - 1, 2**32, 2**62, 2**63 - 2,
                    2**63 - 1], np.int64)


def _i32(g, shape):
    a = g.integers(-2**31, 2**31, shape, dtype=np.int64)
    edge = g.random(shape) < 0.2
    a[edge] = g.choice(EDGES32, int(edge.sum()))
    return a.astype(np.int32)


def _i64(g, shape):
    a = g.integers(0, 2**62, shape, dtype=np.int64)
    edge = g.random(shape) < 0.2
    a[edge] = g.choice(EDGES64, int(edge.sum()))
    return a


def _to_t(tree):
    return convert._convert(tree, lambda a: torch.from_numpy(np.array(a)))


def _word(x) -> int:
    return int(np.asarray(x))


def _evbuf(g, c, h):
    kind = np.where(g.random((c, h)) < 0.6, g.integers(1, 7, (c, h)), 0)
    return EventBufJ(
        time_hi=_i32(g, (c, h)), time_lo=_i32(g, (c, h)),
        t32=_i32(g, (c, h)), tb_hi=_i32(g, (c, h)), tb_lo=_i32(g, (c, h)),
        kind=kind.astype(np.int32), p=_i32(g, (NP, c, h)),
        self_ctr=_i64(g, h), epoch=np.int64(2**40),
        n_elig=_i32(g, h), u32=np.int32(7))


def _outbox(g, p, h):
    return OutboxJ(
        dst=_i32(g, (p, h)), kind=_i32(g, (p, h)), depart_hi=_i32(g, (p, h)),
        depart_lo=_i32(g, (p, h)), ctr=_i32(g, (p, h)), p=_i32(g, (NP, p, h)),
        cnt=g.integers(0, p + 1, h).astype(np.int32), pkt_ctr=_i64(g, h))


def _tcp(g, s, q, h):
    d = {}
    for f in tcp_j._FIELDS_I32:
        d[f] = _i32(g, (s, h))
    d["st"] = np.where(g.random((s, h)) < 0.3, 0,
                       g.integers(1, 12, (s, h))).astype(np.int32)
    for f in tcp_j._FIELDS_I64:
        d[f + "_hi"] = _i32(g, (s, h))
        d[f + "_lo"] = _i32(g, (s, h))
    for f in tcp_j._FIELDS_BOOL:
        d[f] = g.random((s, h)) < 0.5
    d["mq_valid"] = g.random((q, s, h)) < 0.4
    d["mq_end"] = _i32(g, (q, s, h))
    d["mq_meta"] = _i32(g, (q, s, h))
    return d


def _nic(g, h):
    return NicStateJ(*(_i64(g, h) for _ in range(5)))


SHAPES = [(1, 1), (7, 5), (48, 33), (512, 64)]


def _hosts(h, base=0):
    return np.arange(base, base + h, dtype=np.int32)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("c,h", SHAPES)
def test_digest_evbuf_outbox(seed, c, h):
    g = np.random.default_rng(seed * 1000 + c)
    hosts = _hosts(h, base=2**20 * seed)
    buf = _evbuf(g, c, h)
    assert _word(dt.digest_evbuf(_to_t(buf), torch.from_numpy(hosts))) == \
        _word(dj.digest_evbuf(jax.tree.map(jnp.asarray, buf),
                              jnp.asarray(hosts)))
    ob = _outbox(g, max(c // 4, 1), h)
    assert _word(dt.digest_outbox(_to_t(ob), torch.from_numpy(hosts))) == \
        _word(dj.digest_outbox(jax.tree.map(jnp.asarray, ob),
                               jnp.asarray(hosts)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("s,q,h", [(1, 1, 1), (4, 3, 9), (16, 32, 40)])
def test_digest_tcp_nic_rng(seed, s, q, h):
    g = np.random.default_rng(seed * 7 + s)
    hosts = _hosts(h, base=3 * seed)
    ht = torch.from_numpy(hosts)
    tcp = _tcp(g, s, q, h)
    assert _word(dt.digest_tcp(_to_t(tcp), ht)) == _word(
        dj.digest_tcp(jax.tree.map(jnp.asarray, tcp), jnp.asarray(hosts)))
    nic = _nic(g, h)
    assert _word(dt.digest_nic(_to_t(nic), ht)) == _word(
        dj.digest_nic(jax.tree.map(jnp.asarray, nic), jnp.asarray(hosts)))
    vectors = [_i64(g, h), _i64(g, h), _i64(g, h), _i32(g, h)]
    assert _word(dt.digest_rng(ht, [torch.from_numpy(v) for v in vectors])) \
        == _word(dj.digest_rng(jnp.asarray(hosts),
                               [jnp.asarray(v) for v in vectors]))


class _Phold(types.SimpleNamespace):
    _fields = ("hops", "ctr")


@pytest.mark.parametrize("model", ["phold", "net"])
def test_state_digests(model):
    """state_digests of a whole state: PHOLD folds its (hops, ctr) into the
    rng word and has no tcp/nic words; the net model has all five."""
    from shadow1_tpu.core.phold import PholdState as PholdJ
    from shadow1_tpu.net import NetState as NetJ

    g = np.random.default_rng(3 if model == "phold" else 4)
    h = 21
    if model == "phold":
        m = PholdJ(hops=_i64(g, h), ctr=_i64(g, h))
    else:
        m = NetJ(nic=_nic(g, h), tcp=_tcp(g, 4, 5, h), app={})
    st = engine_j.SimState(
        win_start=np.int64(5), evbuf=_evbuf(g, 16, h), outbox=_outbox(g, 4, h),
        model=m, metrics=engine_j.Metrics(*([np.int64(0)] * 37)),
        cpu_busy=_i64(g, h))
    dg_ob = 123456789
    ctx_j = types.SimpleNamespace(hosts=jnp.arange(h, dtype=jnp.int32))
    want = np.asarray(dj.state_digests(jax.tree.map(jnp.asarray, st), ctx_j,
                                       jnp.asarray(dg_ob, jnp.int64)))
    ctx_t = types.SimpleNamespace(hosts=torch.arange(h, dtype=torch.int32))
    got = dt.state_digests(convert.state_from_numpy(st, "cpu"), ctx_t,
                           torch.tensor(dg_ob))
    assert got.tolist() == want.tolist()
    assert (want[2:4] != 0).all() == (model == "net")


def test_ring_schema_matches():
    for name in ("RING_COUNTERS", "RING_WORK", "RING_GAUGES", "RING_DIGESTS",
                 "RING_FIELDS", "REC_RING", "REC_RING_GAP"):
        assert getattr(reg_t, name) == getattr(reg_j, name), name
    assert dt.SUBSYSTEMS == dj.SUBSYSTEMS
    assert reg_t.RING_DIGESTS == dj.DIGEST_FIELDS


def test_ring_record_and_drain():
    """Rows written over more windows than the ring holds: the same rows
    and the same ring_gap record as the reference's."""
    g = np.random.default_rng(9)
    w = 4
    rj = ring_j.ring_init(w)
    rt = ring_t.ring_init(w, "cpu")
    mj = engine_j.Metrics(*([np.int64(0)] * 37))
    for win in range(7):
        m1 = engine_j.Metrics(*(np.int64(v) for v in g.integers(0, 2**40, 37)))
        m1 = m1._replace(windows=np.int64(win + 1))
        fill = np.int64(g.integers(0, 512))
        dg = _i64(g, 5)
        rj = ring_j.ring_record(rj, jax.tree.map(jnp.asarray, mj),
                                jax.tree.map(jnp.asarray, m1),
                                jnp.asarray(fill), digests=jnp.asarray(dg))
        rt = ring_t.ring_record(rt, _to_t(engine_t.Metrics(*mj)),
                                _to_t(engine_t.Metrics(*m1)),
                                torch.tensor(fill), torch.from_numpy(dg))
        mj = m1
    np.testing.assert_array_equal(rt.buf.numpy(), np.asarray(rj.buf))
    sj = types.SimpleNamespace(telem=rj, metrics=mj)
    st = types.SimpleNamespace(telem=rt, metrics=_to_t(engine_t.Metrics(*mj)))
    for start in (0, 2, 5):
        assert ring_t.drain_ring(st, 40_000_000, start) == \
            ring_j.drain_ring(sj, 40_000_000, start)


def test_digest_needs_a_ring():
    from shadow1_tpu_torch.consts import EngineParams

    with pytest.raises(ValueError, match="metrics_ring"):
        engine_t.check_digest_params(EngineParams(state_digest=1))
    engine_t.check_digest_params(EngineParams(state_digest=1, metrics_ring=2))

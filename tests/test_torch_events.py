"""The port's event core equals the JAX package's, leaf for leaf.

Random op sequences — rebase, pop, local push, push-back, outbox append and
window-end delivery (with overflow) — are made with numpy from a seed and
applied to a JAX state and a port state; after every op each leaf of the
event buffer and outbox, and every returned mask and popped field, must be
equal. The JAX side runs once through the "xla" functions of
``shadow1_tpu.core.events``/``outbox`` and once through the fused Pallas
kernels of ``shadow1_tpu.core.popk`` in interpret mode, which ties the
port's plain versions (what its CUDA kernels are held to on the card) to
the TPU kernels themselves. The port side runs on CPU tensors, so its
wrappers in ``shadow1_tpu_torch.core.popk`` take the plain versions.
Outbox appends also run on edge cases the random sequence never reaches
(large packet counters, departure low words at and above 2**31, 0-d
rows, full outboxes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu.consts import NP, TB_PACKET_BASE
from shadow1_tpu.core import events as ej
from shadow1_tpu.core import outbox as oj
from shadow1_tpu.core import popk as pj
from shadow1_tpu_torch.core import events as et
from shadow1_tpu_torch.core import outbox as ot
from shadow1_tpu_torch.core import popk as pt

W = 1000  # window, ns


def assert_same(j, t, what: str) -> None:
    """Equal values and dtypes, recursing through NamedTuples."""
    if isinstance(j, tuple) and hasattr(j, "_fields"):
        assert j._fields == t._fields, what
        for f in j._fields:
            assert_same(getattr(j, f), getattr(t, f), f"{what}.{f}")
        return
    a = np.asarray(j)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.ndim == 0 and b.ndim == 0:
        assert int(a) == int(b), f"{what}: jax {a} port {b}"
        return
    assert a.dtype == b.dtype, f"{what}: jax {a.dtype} port {b.dtype}"
    np.testing.assert_array_equal(b, a, err_msg=what)


_jit = functools.partial(jax.jit, static_argnames=("extract",))
_pop_xla = _jit(ej.pop_until)
_push_local_xla = jax.jit(ej.push_local)
_push_back_xla = jax.jit(ej.push_back)
_outbox_append_xla = jax.jit(oj.outbox_append)
_deliver_batch = jax.jit(ej.deliver_batch)
_rebase = jax.jit(ej.rebase)


class JaxOps:
    """The reference's event-core ops, through "xla" or the Pallas kernels
    (the "xla" ones jitted, so each compiles once per shape)."""

    def __init__(self, impl: str):
        self.impl = impl

    def pop(self, buf, until):
        if self.impl == "pallas":
            return pj.pop_until_fused(buf, until, interpret=True)
        return _pop_xla(buf, until, extract=self.impl)

    def push_local(self, buf, mask, time, kind, p):
        if self.impl == "pallas":
            return pj.push_local_fused(buf, mask, time, kind, p, interpret=True)
        return _push_local_xla(buf, mask, time, kind, p)

    def push_back(self, buf, mask, time, tb, kind, p):
        if self.impl == "pallas":
            return pj.push_back_fused(buf, mask, time, tb, kind, p,
                                      interpret=True)
        return _push_back_xla(buf, mask, time, tb, kind, p)

    def outbox_append(self, ob, mask, dst, kind, depart, p):
        if self.impl == "pallas":
            return pj.outbox_append_fused(ob, mask, dst, kind, depart, p,
                                          interpret=True)
        return _outbox_append_xla(ob, mask, dst, kind, depart, p)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("impl", ["sum", "gather", "pallas"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence(impl, seed):
    g = np.random.default_rng(seed)
    c = int(g.integers(8, 17))
    h = int(g.integers(32, 65))
    cap_p = int(g.integers(4, 9))
    ops = JaxOps(impl)
    bj, bt = ej.evbuf_init(h, c), et.evbuf_init(h, c, "cpu")
    obj, obt = oj.outbox_init(h, cap_p), ot.outbox_init(h, cap_p, "cpu")
    now = 0
    pkt_ctr = 0
    back_ctr = 1 << 40  # push_back tie-breaks: unique, apart from self_ctr's
    n_pops = n_over = 0

    def rows():
        mask = g.random(h) < 0.7
        time = now + g.integers(0, 3 * W, h, dtype=np.int64)
        kind = g.integers(1, 7, h).astype(np.int32)
        p = g.integers(-2**31, 2**31, (NP, h), dtype=np.int64).astype(np.int32)
        return mask, time, kind, p

    for step in range(60):
        op = g.choice(["push", "push", "pop", "pop", "back", "obox",
                       "deliver", "rebase"])
        if op == "push":
            m, t, k, p = rows()
            (bj, oj_), (bt, ot_) = (
                ops.push_local(bj, *(_both(x)[0] for x in (m, t, k, p))),
                pt.push_local(bt, *(_both(x)[1] for x in (m, t, k, p))))
            assert_same(oj_, ot_, f"{step} push overflow")
            n_over += int(np.asarray(oj_).sum())
        elif op == "back":
            m, t, k, p = rows()
            tb = back_ctr + np.arange(h, dtype=np.int64)
            back_ctr += h
            (bj, oj_), (bt, ot_) = (
                ops.push_back(bj, *(_both(x)[0] for x in (m, t, tb, k, p))),
                pt.push_back(bt, *(_both(x)[1] for x in (m, t, tb, k, p))))
            assert_same(oj_, ot_, f"{step} push_back overflow")
        elif op == "pop":
            until = now + int(g.integers(0, 2 * W))
            bj, evj = ops.pop(bj, jnp.int64(until))
            bt, evt = pt.pop_until(bt, torch.tensor(until), extract=(
                impl if impl != "pallas" else "sum"))
            assert_same(evj, evt, f"{step} popped")
            n_pops += int(np.asarray(evj.mask).sum())
        elif op == "obox":
            m, t, k, p = rows()
            dst = g.integers(0, h, h).astype(np.int32)
            (obj, okj), (obt, okt) = (
                ops.outbox_append(obj, *(_both(x)[0] for x in (m, dst, k, t, p))),
                pt.outbox_append(obt, *(_both(x)[1] for x in (m, dst, k, t, p))))
            assert_same(okj, okt, f"{step} outbox ok")
        elif op == "deliver":
            n = 3 * h
            # A third of the packets go to one host, to overflow it.
            dst = np.where(g.random(n) < 0.33, int(g.integers(0, h)),
                           g.integers(0, h, n)).astype(np.int32)
            time = now + W + g.integers(0, 3 * W, n, dtype=np.int64)
            src = g.integers(0, h, n, dtype=np.int64)
            tb = TB_PACKET_BASE + (src << 32) + pkt_ctr + np.arange(n)
            pkt_ctr += n
            kind = g.integers(1, 7, n).astype(np.int32)
            p = g.integers(-2**31, 2**31, (NP, n), dtype=np.int64).astype(np.int32)
            mask = g.random(n) < 0.8
            args = (dst, time, tb, kind, p, mask)
            bj, nj = _deliver_batch(bj, *(_both(x)[0] for x in args))
            bt, nt = et.deliver_batch(bt, *(_both(x)[1] for x in args))
            assert_same(nj, nt, f"{step} deliver overflow")
            n_over += int(nj)
        else:
            now += int(g.integers(0, 2 * W))
            bj = _rebase(bj, jnp.int64(now), jnp.int64(now + W))
            bt = et.rebase(bt, torch.tensor(now), torch.tensor(now + W))
        assert_same(bj, bt, f"{step} {op} evbuf")
        assert_same(obj, obt, f"{step} {op} outbox")
    # The sequence exercised what it is meant to.
    assert n_pops > 0 and n_over > 0
    assert_same(ej.evbuf_fill(bj), et.evbuf_fill(bt), "evbuf_fill")
    assert_same(oj.outbox_fill(obj), ot.outbox_fill(obt), "outbox_fill")


OBOX_EDGES = ["pkt_ctr", "depart", "0-d dst and kind", "0-d depart",
              "idle tiles", "full outbox", "cnt at P - 1"]


def _obox_edge(case: str, g, h: int = 100, cap: int = 6):
    """An outbox and three sets of append rows for one edge case the random
    op sequence never reaches (its pkt_ctr stays small, its departures
    below 2**31): pkt_ctr at and above 2**31, 2**32 and 2**33 (and at
    I64_MAX, where the next append wraps); departures whose low words lie
    at and above 2**31, and I64_MAX; 0-d dst and kind, or a 0-d depart;
    whole 32-host tiles with no appending host; a full outbox; every cnt
    at P - 1, so the first append fills it and the next ones drop."""
    def rnd(*shape):
        return g.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)

    cnt = g.integers(0, cap, h).astype(np.int32)
    pkt_ctr = g.integers(0, 2**20, h)
    if case == "pkt_ctr":
        pkt_ctr = g.choice(np.array([2**31 - 1, 2**31, 2**32 - 1, 2**32,
                                     2**33 + 7, 2**40 + 2**31, 2**63 - 1]), h)
    elif case == "full outbox":
        cnt[:] = cap
    elif case == "cnt at P - 1":
        cnt[:] = cap - 1
    ob = (rnd(cap, h), rnd(cap, h), rnd(cap, h), rnd(cap, h), rnd(cap, h),
          rnd(NP, cap, h), cnt, pkt_ctr)
    steps = []
    for _ in range(3):
        mask = g.random(h) < 0.8
        dst = g.integers(0, h, h).astype(np.int32)
        kind = g.integers(1, 7, h).astype(np.int32)
        depart = g.integers(0, 2**40, h)
        if case == "depart":
            lo = g.choice(np.array([0, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1]), h)
            depart = (g.integers(0, 2**20, h) << 32) | lo
            depart[g.random(h) < 0.2] = 2**63 - 1
        elif case == "0-d dst and kind":
            dst, kind = np.array(7, np.int32), np.array(3, np.int32)
        elif case == "0-d depart":
            depart = np.array(2**40 + 2**31 + 3, np.int64)
        elif case == "idle tiles":
            mask[:64] = False
        steps.append((mask, dst, kind, depart, rnd(NP, h)))
    return ob, steps


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", OBOX_EDGES)
def test_outbox_append_edges(impl, case):
    """The port's outbox_append (its plain version, on the CPU) equals the
    reference's, leaf for leaf, on the edge cases the CUDA kernel must
    handle bit-exactly."""
    g = np.random.default_rng(OBOX_EDGES.index(case))
    ob, steps = _obox_edge(case, g)
    obj = oj.Outbox(*(jnp.asarray(x) for x in ob))
    obt = ot.Outbox(*(torch.from_numpy(x) for x in ob))
    ops = JaxOps(impl)
    n_ok = 0
    for i, (mask, dst, kind, depart, p) in enumerate(steps):
        if impl == "pallas":  # the fused wrapper broadcasts dst and kind only
            depart = np.broadcast_to(depart, mask.shape)
        args = (mask, dst, kind, depart, p)
        obj, okj = ops.outbox_append(obj, *(jnp.asarray(x) for x in args))
        obt, okt = pt.outbox_append(obt, *(torch.from_numpy(np.array(x))
                                           for x in args))
        assert_same(okj, okt, f"{case} step {i} ok")
        assert_same(obj, obt, f"{case} step {i} outbox")
        n_ok += int(np.asarray(okj).sum())
    assert (n_ok == 0) == (case == "full outbox")
    if case == "cnt at P - 1":  # each host takes one packet, then is full
        assert n_ok == int(np.any([s[0] for s in steps], axis=0).sum())


@pytest.mark.parametrize("v", [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
                               (1 << 62) + 7, (1 << 62) + (5 << 32) + 2**31,
                               (1 << 63) - 1])
def test_tb_split_join_match(v):
    """The (hi, lo) split, including low words at and above 2**31 where
    the reference's u32 → i32 cast flips the sign."""
    vals = np.array([v], np.int64)
    hj, lj = ej.tb_split(jnp.asarray(vals))
    ht, lt = et.tb_split(torch.from_numpy(vals))
    assert_same(hj, ht, "hi")
    assert_same(lj, lt, "lo")
    assert_same(ej.tb_join(hj, lj), et.tb_join(ht, lt), "join")
    assert int(et.tb_join(ht, lt)[0]) == v


def test_pop_drains_in_key_order():
    """Same-time events pop in tie-break order, and a buffer drains to
    empty with every slot freed."""
    h, c = 4, 8
    bt = et.evbuf_init(h, c, "cpu")
    k = torch.full((h,), 1, dtype=torch.int32)
    p = torch.zeros((NP, h), dtype=torch.int32)
    for t in (5, 3, 5, 3):
        bt, _ = pt.push_local(bt, torch.ones(h, dtype=torch.bool),
                              torch.full((h,), t), k, p)
    bt = et.rebase(bt, torch.tensor(0), torch.tensor(10))
    seen = []
    while et.any_eligible(bt):
        bt, ev = pt.pop_until(bt, torch.tensor(10))
        seen.append((int(ev.time[0]), int(ev.tb[0])))
    assert seen == [(3, 1), (3, 3), (5, 0), (5, 2)]
    assert bool((bt.kind == 0).all()) and int(et.evbuf_fill(bt)) == 0

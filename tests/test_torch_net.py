"""Slice 2 of the port: the net stack (NIC, TCP, filexfer), against the JAX
package on the CPU.

Every comparison is bit-exact, on inputs made from a numpy seed: the NIC
stamps on random rows; the batched NIC-arrival pass (``make_pre_window``)
on random event buffers; and ``configs/rung1_filexfer.yaml``'s first 150
windows through both engines — every ``Metrics`` field, the summary
arrays, every ring row (its digest words included) and every state leaf at
windows 50 and 150. A JAX state carried into the port at window 50 goes on
bit-exactly, and the port's command line equals the JAX engine's metrics
and ring rows. The JAX reference runs once per module.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from shadow1_tpu import net as net_j
from shadow1_tpu.config import experiment as xj
from shadow1_tpu.consts import K_APP, K_PKT, K_PKT_DELIVER, NP
from shadow1_tpu.core import events as ev_j
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.net import nic as nic_j
from shadow1_tpu.telemetry.ring import drain_ring as drain_j
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import net as net_t
from shadow1_tpu_torch.config import experiment as xt
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.net import nic as nic_t
from shadow1_tpu_torch.telemetry.ring import drain_ring as drain_t

ROOT = Path(__file__).resolve().parents[1]
RUNG1 = ROOT / "configs" / "rung1_filexfer.yaml"
WINDOWS, MID = 150, 50


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU path runs thousands of tiny tensor ops per round;
    one intra-op thread keeps them from fighting the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rung1(params_extra):
    with open(RUNG1) as f:
        doc = yaml.safe_load(f)
    base = str(RUNG1.parent)
    exp_j, par_j, _ = xj.build_experiment(copy.deepcopy(doc), base_dir=base)
    exp_t, par_t, _ = xt.build_experiment(copy.deepcopy(doc), base_dir=base)
    return ((exp_j, dataclasses.replace(par_j, **params_extra)),
            (exp_t, dataclasses.replace(par_t, **params_extra)))


RING = dict(metrics_ring=WINDOWS, state_digest=1)


def _np_tree(st):
    return jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX engine on rung1: the states at windows MID and WINDOWS, the
    ring rows drained at each, the metrics and the summary at WINDOWS."""
    (exp, params), _ = _rung1(RING)
    eng = EngineJ(exp, params)
    st_mid = eng.run(n_windows=MID)
    st_end = eng.run(st_mid, n_windows=WINDOWS - MID)
    return types.SimpleNamespace(
        mid=_np_tree(st_mid), end=_np_tree(st_end),
        rows_mid=drain_j(st_mid, exp.window), rows=drain_j(st_end, exp.window),
        metrics=EngineJ.metrics_dict(st_end),
        summary=jax.tree.map(np.asarray, eng.model_summary(st_end)))


def _assert_same_leaves(want, got):
    lw, lg = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(lw) == len(lg)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    for path, a, b in zip(paths, lw, lg):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=path)


def test_rung1_matches_jax(jax_run):
    """150 windows of rung1: metrics, summary, ring rows (digests
    included) and every state leaf at windows 50 and 150."""
    _, (exp, params) = _rung1(RING)
    eng = EngineT(exp, params, device="cpu")
    st_mid = eng.run(n_windows=MID)
    _assert_same_leaves(jax_run.mid, convert.state_to_numpy(st_mid))
    st = eng.run(st_mid, n_windows=WINDOWS - MID)
    mt = EngineT.metrics_dict(st)
    assert list(mt) == list(jax_run.metrics) and mt == jax_run.metrics
    assert mt["events"] > 0 and mt["pops_deliver"] > 0 and mt["pkts_lost"] > 0
    assert mt["tcp_fast_rtx"] > 0
    summ = eng.model_summary(st)
    assert set(summ) == set(jax_run.summary)
    for k, v in jax_run.summary.items():
        np.testing.assert_array_equal(summ[k], v, err_msg=k)
    assert drain_t(st, exp.window) == jax_run.rows
    assert any(r["dg_tcp"] and r["dg_outbox"] for r in jax_run.rows)
    _assert_same_leaves(jax_run.end, convert.state_to_numpy(st))


def test_state_carried_from_jax(jax_run):
    """The JAX state at window 50, carried into the port, goes on to window
    150 bit-exactly."""
    _, (exp, params) = _rung1(RING)
    eng = EngineT(exp, params, device="cpu")
    st = eng.run(convert.state_from_numpy(jax_run.mid, "cpu"),
                 n_windows=WINDOWS - MID)
    assert EngineT.metrics_dict(st) == jax_run.metrics
    _assert_same_leaves(jax_run.end, convert.state_to_numpy(st))


def test_cli_state_digest_matches_jax(jax_run):
    """``--device cpu --windows 50 --state-digest on``: the ring rows before
    the result line, then the metrics, equal the JAX engine's."""
    out = subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch", str(RUNG1), "--device",
         "cpu", "--windows", str(MID), "--state-digest", "on"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = [json.loads(s) for s in out.stdout.strip().splitlines()]
    assert lines[:-1] == jax_run.rows_mid
    assert len(lines) == MID + 1
    jax_mid = {k: int(v) for k, v in
               jax_run.mid.metrics._asdict().items()}
    assert lines[-1]["metrics"] == jax_mid


# -- the NIC ----------------------------------------------------------------

def _nic_rows(g, h):
    nic = [g.integers(0, 2**40, h) for _ in range(5)]
    mask = g.random(h) < 0.6
    wire = g.integers(40, 1600, h)
    now = g.integers(0, 2**40, h)
    now[::3] = nic[0][::3] + g.integers(-5000, 5000, h)[::3]
    bw = g.choice(np.array([10**6, 10**7, 2 * 10**7, 10**9, 7_777_777]), h)
    qlen = g.integers(0, 20_000, h)
    return nic, mask, wire, now, bw, qlen


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("bounded", [False, True])
def test_nic_stamps_match_jax(seed, bounded):
    g = np.random.default_rng(seed)
    h = 257
    nic, mask, wire, now, bw, qlen = _nic_rows(g, h)
    t = torch.from_numpy
    nj = nic_j.NicState(*(jnp.asarray(a) for a in nic))
    nt = nic_t.NicState(*(t(a) for a in nic))
    q_j = jnp.asarray(qlen) if bounded else None
    q_t = t(qlen) if bounded else None
    np.testing.assert_array_equal(
        nic_t.ser_delay(t(wire), t(bw)).numpy(),
        np.asarray(nic_j.ser_delay(jnp.asarray(wire), jnp.asarray(bw))))
    want = nic_j.tx_stamp(nj, jnp.asarray(mask), jnp.asarray(wire),
                          jnp.asarray(now), jnp.asarray(bw), q_j)
    got = nic_t.tx_stamp(nt, t(mask), t(wire), t(now), t(bw), q_t)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), got))):
        np.testing.assert_array_equal(b, np.asarray(a))
    want = nic_j.rx_stamp(nj, jnp.asarray(mask), jnp.asarray(wire),
                          jnp.asarray(now), jnp.asarray(bw), q_j)
    got = nic_t.rx_stamp(nt, t(mask), t(wire), t(now), t(bw), q_t)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), got))):
        np.testing.assert_array_equal(b, np.asarray(a))


# -- the batched NIC arrivals -------------------------------------------------

class _Model(NamedTuple):
    nic: Any


class _State(NamedTuple):
    evbuf: Any
    model: Any
    metrics: Any


WIN_END = 10**9 + 40_000_000


def _arrival_buffer(g, c, h):
    """An event buffer (numpy leaves) of K_PKT and other events around a
    window ending at WIN_END: host 0 has none, host 1 has only valid K_PKT
    slots, host 2 has equal arrival times with distinct tie-breaks (low
    words on both sides of 2**31), host 3 has arrivals after WIN_END only;
    the rest are random. Also an rx_free row, ahead of every arrival on
    host 4."""
    kind = np.where(g.random((c, h)) < 0.7,
                    g.choice(np.array([K_PKT, K_PKT, K_PKT_DELIVER, K_APP]),
                             (c, h)), 0)
    time = WIN_END - g.integers(-20_000_000, 60_000_000, (c, h))
    kind[:, 0] = np.where(kind[:, 0] == K_PKT, K_APP, kind[:, 0])
    kind[:, 1] = K_PKT
    time[:, 1] = WIN_END - 1 - g.integers(0, 40_000_000, c)
    kind[:, 2] = K_PKT
    time[:, 2] = WIN_END - 1000
    time[:, 3] = WIN_END + g.integers(0, 10**6, c)
    time[kind == 0] = ev_j.I64_MAX
    base = (1 << 62) + (np.arange(h)[None, :] << 32)
    tb = base + g.permutation(np.arange(c, dtype=np.int64) * 2**27 + 7)[:, None]
    tb[:, 2] = (1 << 62) + (g.permutation(c) - c // 2) * 2**26 + 2**31
    p = g.integers(-2**31, 2**31, (NP, c, h), dtype=np.int64).astype(np.int32)
    p[4] = g.integers(0, 1461, (c, h))
    rx_free = WIN_END - g.integers(0, 60_000_000, h)
    rx_free[4] = WIN_END + 10**7
    return kind, time, tb, p, rx_free


def _evbuf_j(kind, time, tb, p, h):
    thi, tlo = ev_j.tb_split(jnp.asarray(time))
    bhi, blo = ev_j.tb_split(jnp.asarray(tb))
    return ev_j.EventBuf(
        time_hi=thi, time_lo=tlo,
        t32=jnp.zeros(kind.shape, jnp.int32), tb_hi=bhi, tb_lo=blo,
        kind=jnp.asarray(kind, jnp.int32), p=jnp.asarray(p),
        self_ctr=jnp.zeros(h, jnp.int64), epoch=jnp.zeros((), jnp.int64),
        n_elig=jnp.zeros(h, jnp.int32),
        u32=jnp.asarray(ev_j.I32_HORIZON, jnp.int32))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("c,h", [(8, 6), (64, 12), (512, 5)])
def test_pre_window_matches_jax(seed, c, h):
    g = np.random.default_rng(100 * seed + c)
    kind, time, tb, p, rx_free = _arrival_buffer(g, c, h)
    bw = g.choice(np.array([10**7, 2 * 10**7, 10**9, 3_333_333]), h)
    nic = [rx_free if i == 1 else g.integers(0, 2**30, h) for i in range(5)]
    ctx_j = types.SimpleNamespace(has_rx_qlen=False, has_cpu=False,
                                  has_stop=False, bw_dn=jnp.asarray(bw))
    st_j = _State(_evbuf_j(kind, time, tb, p, h),
                  _Model(nic_j.NicState(*(jnp.asarray(a) for a in nic))), 0)
    want = net_j.make_pre_window(ctx_j)(st_j, ctx_j, jnp.asarray(WIN_END))
    ctx_t = types.SimpleNamespace(bw_dn=torch.from_numpy(bw))
    st_t = _State(
        convert._convert(_np_tree(st_j.evbuf),
                         lambda a: torch.from_numpy(np.array(a))),
        _Model(nic_t.NicState(*(torch.from_numpy(a) for a in nic))), 0)
    got = net_t.make_pre_window(ctx_t)(st_t, ctx_t, torch.tensor(WIN_END))
    assert int((np.asarray(want.evbuf.kind) == K_PKT_DELIVER).sum()) > int(
        (kind == K_PKT_DELIVER).sum())
    _assert_same_leaves(_np_tree((want.evbuf, want.model.nic)),
                        jax.tree.map(lambda x: x.numpy(),
                                     (got.evbuf, got.model.nic)))


# -- the dense helpers TCP uses ---------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", [(5, 7), (3, 16, 9), (32, 16, 4)])
def test_dense_helpers_match_jax(seed, shape):
    """get_col, set_col and add_col over [C, H] and [Q, S, H] planes (the
    column on the second-to-last axis, out-of-range columns included);
    last_true and first_true_idx over a bool [C, H]."""
    from shadow1_tpu.core import dense as dj
    from shadow1_tpu_torch.core import dense as dt

    g = np.random.default_rng(seed)
    c, h = shape[-2], shape[-1]
    arr = g.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    col = g.integers(-1, c + 1, h).astype(np.int32)
    mask = g.random(h) < 0.6
    val = g.integers(-2**31, 2**31, shape[:-2] + (h,),
                     dtype=np.int64).astype(np.int32)
    t = torch.from_numpy
    J = jnp.asarray
    np.testing.assert_array_equal(dt.get_col(t(arr), t(col)).numpy(),
                                  np.asarray(dj.get_col(J(arr), J(col))))
    for v_t, v_j in ((t(val), J(val)), (7, 7)):
        np.testing.assert_array_equal(
            dt.set_col(t(arr), t(col), v_t, t(mask)).numpy(),
            np.asarray(dj.set_col(J(arr), J(col), v_j, J(mask))))
        np.testing.assert_array_equal(
            dt.add_col(t(arr), t(col), v_t, t(mask)).numpy(),
            np.asarray(dj.add_col(J(arr), J(col), v_j, J(mask))))
    m = g.random((c, h)) < 0.3
    m[:, 0] = False
    for f in ("last_true", "first_true_idx"):
        a_t, i_t = getattr(dt, f)(t(m))
        a_j, i_j = getattr(dj, f)(J(m))
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        assert i_t.dtype == torch.int32


def _refused_doc(kind):
    if kind in ("tor", "bitcoin"):
        name = {"tor": "rung3_tor1k.yaml", "bitcoin": "rung5_bitcoin5k.yaml"}
        with open(ROOT / "configs" / name[kind]) as f:
            return yaml.safe_load(f)
    with open(RUNG1) as f:
        doc = yaml.safe_load(f)
    host = doc["hosts"][0]
    if kind == "dgram":
        doc["app"] = {"model": "dgram", "groups": {"client": {"dst": "@server"}}}
    elif kind == "aqm":
        host.update(aqm_min_bytes=20000, aqm_max_bytes=60000)
    else:
        host[kind] = 30000
    return doc


@pytest.mark.parametrize("kind", ["tor", "bitcoin", "dgram", "aqm",
                                  "tx_queue_bytes", "rx_queue_bytes"])
def test_net_refusals_name_roadmap(kind):
    """What the net slice does not run yet fails loudly, naming its ROADMAP
    item: the other apps, NIC queue bounds and RED AQM."""
    item = "the other apps" if kind in ("tor", "bitcoin", "dgram") else \
        "NIC queue bounds and RED AQM"
    with pytest.raises(NotImplementedError, match=f"ROADMAP: {item}"):
        exp, params, _ = xt.build_experiment(_refused_doc(kind),
                                             base_dir=str(RUNG1.parent))
        EngineT(exp, params, device="cpu")

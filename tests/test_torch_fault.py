"""The port's fault plane against the JAX package, on the CPU.

* ``fault/schedule.py``: the host interval tensors (legacy stop_time
  merged in, up times quantized up to the window, padding), the rejection
  of intervals that overlap once quantized, and ``faults:`` parsing, each
  equal to the JAX package's;
* ``fault/plane.py``: every function against its JAX twin on seeded
  random inputs, and the batched NIC arrival pass discarding a down
  host's arrivals;
* the engine: dead-host drop accounting and the restart reset (PHOLD
  under host churn), a TCP flow that survives a link outage through its
  retransmit timer (with a loss ramp after it), and
  ``configs/churn_filexfer.yaml`` — its first 35 windows here, whole
  (150 windows) in a ``slow`` test. Each run equals the JAX ``Engine``
  bit for bit: every ``Metrics`` field, summary array, ring row (digest
  words included) and state leaf, mid-run and at the end. Each asserts
  that its fault fired.
"""

import copy
import dataclasses
import types
from pathlib import Path
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from shadow1_tpu.config import experiment as xj
from shadow1_tpu.fault import plane as plane_j
from shadow1_tpu.fault import schedule as sched_j
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config import experiment as xt
from shadow1_tpu_torch.fault import plane as plane_t
from shadow1_tpu_torch.fault import schedule as sched_t
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import (  # noqa: F401  (fixture)
    _one_thread,
    assert_port_matches,
    jax_reference,
)

ROOT = Path(__file__).resolve().parents[1]
MS, SEC = 10**6, 10**9
NO_STOP = ct.NO_STOP


def _phold_exp(n_hosts=4, end=100 * MS, latency=10 * MS):
    return ct.single_vertex_experiment(
        n_hosts=n_hosts, seed=3, end_time=end, latency_ns=latency,
        model="phold", model_cfg={"mean_delay_ns": float(MS),
                                  "init_events": 2})


def test_host_interval_tensors_merge_and_quantize():
    exp = _phold_exp()
    exp.stop_time[3] = 55 * MS  # the legacy knob merges in
    exp.faults = sched_t.FaultSchedule(
        host_id=[1, 1], host_down=[15 * MS, 61 * MS],
        host_up=[23 * MS, 75 * MS])  # neither is window-aligned
    down, up = sched_t.host_interval_tensors(exp)
    want = sched_j.host_interval_tensors(jax_experiment(exp))
    np.testing.assert_array_equal(down, want[0])
    np.testing.assert_array_equal(up, want[1])
    assert down.shape == (2, 4) and down.dtype == up.dtype == np.int64
    assert down[:, 1].tolist() == [15 * MS, 61 * MS]
    assert up[:, 1].tolist() == [30 * MS, 80 * MS]
    assert down[0, 3] == 55 * MS and up[0, 3] == NO_STOP
    assert down[:, 0].tolist() == [NO_STOP, NO_STOP]


def test_host_intervals_overlap_after_quantization_rejected():
    exp = _phold_exp(n_hosts=2)
    exp.faults = sched_t.FaultSchedule(
        host_id=[0, 0], host_down=[15 * MS, 22 * MS],
        host_up=[21 * MS, 40 * MS])  # up quantizes to 30 ms > next down
    with pytest.raises(ValueError, match="overlap"):
        sched_t.host_interval_tensors(exp)


_FAULTS_DOC = {
    "general": {"seed": 3, "stop_time": "2 s"},
    "network": {"single_vertex": {"latency": "10 ms"}},
    "hosts": [{"name": "a", "count": 2}, {"name": "b", "count": 2}],
    "app": {"model": "phold"},
    "faults": {
        "hosts": [
            {"group": "b", "down_at": "100 ms", "up_at": "200 ms"},
            {"host": 0, "down_at": "1 s"},  # no up_at: a kill
            {"hosts": [1, 2], "down_at": "1.5 s", "up_at": "1.7 s"},
        ],
        "links": [{"src_vertex": 0, "dst_vertex": 0, "down_at": "300 ms",
                   "up_at": "400 ms"}],
        "loss": [{"src_vertex": 0, "dst_vertex": 0, "from": "1 s",
                  "until": "1.5 s", "loss": 0.25}],
    },
}


def _load(name):
    with open(ROOT / "configs" / name) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("which", ["doc", "churn_filexfer"])
def test_faults_parsing_matches_jax(which):
    """A ``faults:`` section compiles to the JAX package's FaultSchedule,
    field for field and dtype for dtype; ``churn_filexfer.yaml`` (graphml
    vertex names, bidirectional entries) to the same tables too."""
    if which == "doc":
        doc, base = _FAULTS_DOC, "."
    else:
        doc, base = _load("churn_filexfer.yaml"), str(ROOT / "configs")
    exp_j, _, _ = xj.build_experiment(copy.deepcopy(doc), base_dir=base)
    exp_t, _, _ = xt.build_experiment(copy.deepcopy(doc), base_dir=base)
    assert isinstance(exp_t.faults, sched_t.FaultSchedule)
    for f in dataclasses.fields(sched_j.FaultSchedule):
        a, b = getattr(exp_j.faults, f.name), getattr(exp_t.faults, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    for fn in ("host_interval_tensors", "link_tables", "ramp_tables"):
        want = getattr(sched_j, fn)(exp_j)
        got = getattr(sched_t, fn)(exp_t)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a, err_msg=fn)
    if which == "doc":
        assert exp_t.faults.host_id.tolist() == [2, 3, 0, 1, 2]
        assert len(exp_t.faults.link_src) == 1  # src == dst: one entry
    else:
        assert len(exp_t.faults.link_src) == 2  # both directions
    assert sched_t.parse_faults({}, [], []) is None
    assert ct.experiment_from_arrays(ct.experiment_arrays(exp_t)).faults \
        .host_up.tolist() == exp_t.faults.host_up.tolist()


@pytest.mark.parametrize("seed", range(3))
def test_plane_functions_match_jax(seed):
    """Every fault-plane function on seeded random tables and times."""
    g = np.random.default_rng(seed)
    k, c, h, n, v = 3, 5, 37, 400, 4
    down = np.sort(g.integers(0, 10**6, (k, h)), axis=0)
    up = down + g.integers(1, 3 * 10**5, (k, h))
    down[-1, ::4] = up[-1, ::4] = NO_STOP
    t_ch = g.integers(0, 2 * 10**6, (c, h))
    idx = g.integers(0, h, n)
    t_n = g.integers(0, 2 * 10**6, n)
    vs, vd = g.integers(0, v, n), g.integers(0, v, n)
    dep = g.integers(0, 10**6, n)
    lf = (g.integers(0, v, 3), g.integers(0, v, 3),
          g.integers(0, 5 * 10**5, 3), g.integers(5 * 10**5, 10**6, 3))
    rt = lf + (np.round(g.random(3) * 2.0**32).astype(np.uint64),)
    thr = np.round(g.random(n) * 2.0**32).astype(np.uint64)
    win = int(up[0, 7])

    def J(a):
        return jnp.asarray(a)

    def T(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64))

    pairs = [
        (plane_j.hosts_down_at(J(down), J(up), J(t_ch)),
         plane_t.hosts_down_at(T(down), T(up), T(t_ch))),
        (plane_j.hosts_down_at(J(down), J(up), J(t_ch[0])),
         plane_t.hosts_down_at(T(down), T(up), T(t_ch[0]))),
        (plane_j.hosts_down_at_idx(J(down), J(up), J(idx), J(t_n)),
         plane_t.hosts_down_at_idx(T(down), T(up), T(idx), T(t_n))),
        (plane_j.link_down_mask(tuple(map(J, lf)), J(vs), J(vd), J(dep)),
         plane_t.link_down_mask(tuple(map(T, lf)), T(vs), T(vd), T(dep))),
        (plane_j.ramp_loss_thr(tuple(map(J, rt)), J(vs), J(vd), J(dep),
                               J(thr)),
         plane_t.ramp_loss_thr(tuple(map(T, rt)), T(vs), T(vd), T(dep),
                               T(thr))),
        (plane_j.restart_mask(J(up), J(np.int64(win))),
         plane_t.restart_mask(T(up), torch.tensor(win))),
    ]
    for i, (want, got) in enumerate(pairs):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(got.numpy().dtype),
                                      err_msg=str(i))
    assert pairs[0][1].any() and pairs[3][1].any() and pairs[5][1].any()
    # reset_host_columns: every leaf whose last axis is H, of any rank and
    # dtype, takes the initial value on the masked hosts; others pass.
    mask = g.random(h) < 0.4
    cur = {"a": g.integers(0, 9, (2, c, h)), "b": g.random(h) < 0.5,
           "c": g.integers(0, 9, (h, 3)), "s": np.int64(7)}
    ini = {"a": g.integers(0, 9, (2, c, h)), "b": g.random(h) < 0.5,
           "c": g.integers(0, 9, (h, 3)), "s": np.int64(1)}
    want = plane_j.reset_host_columns(
        {k: J(x) for k, x in cur.items()}, {k: J(x) for k, x in ini.items()},
        J(mask), h)
    got = plane_t.reset_host_columns(
        {k: torch.as_tensor(x) for k, x in cur.items()},
        {k: torch.as_tensor(x) for k, x in ini.items()},
        torch.from_numpy(mask), h)
    for key in cur:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


class _Metrics(NamedTuple):
    down_events: Any


@pytest.mark.parametrize("seed", range(3))
def test_pre_window_discards_dead_arrivals_like_jax(seed):
    """The batched NIC arrival pass under churn: arrivals of a host that
    is down at their time are discarded unprocessed (``down_events``) and
    reserve no downlink; the rest convert as without churn — event buffer,
    NIC state and count equal the JAX package's."""
    from shadow1_tpu import net as net_j
    from shadow1_tpu.net import nic as nic_j
    from shadow1_tpu_torch import convert
    from shadow1_tpu_torch import net as net_t
    from shadow1_tpu_torch.net import nic as nic_t
    from tests.test_torch_net import (
        WIN_END,
        _arrival_buffer,
        _assert_same_leaves,
        _evbuf_j,
        _Model,
        _np_tree,
        _State,
    )

    g = np.random.default_rng(seed)
    c, h = 64, 12
    kind, time, tb, p, rx_free = _arrival_buffer(g, c, h)
    bw = g.choice(np.array([10**7, 2 * 10**7, 10**9, 3_333_333]), h)
    nic = [rx_free if i == 1 else g.integers(0, 2**30, h) for i in range(5)]
    # Hosts 1, 2 and 5-8 are down over part of the window's arrivals.
    down = np.full((2, h), NO_STOP, np.int64)
    up = np.full((2, h), NO_STOP, np.int64)
    for i in (1, 2, 5, 6, 7, 8):
        down[0, i] = WIN_END - g.integers(10**6, 3 * 10**7)
        up[0, i] = down[0, i] + g.integers(10**6, 2 * 10**7)
    down[1, 6], up[1, 6] = up[0, 6] + 10**6, NO_STOP
    flags = dict(has_rx_qlen=False, has_cpu=False, has_stop=True)
    ctx_j = types.SimpleNamespace(**flags, bw_dn=jnp.asarray(bw),
                                  fault_down=jnp.asarray(down),
                                  fault_up=jnp.asarray(up))
    st_j = _State(_evbuf_j(kind, time, tb, p, h),
                  _Model(nic_j.NicState(*(jnp.asarray(a) for a in nic))),
                  _Metrics(jnp.zeros((), jnp.int64)))
    want = net_j.make_pre_window(ctx_j)(st_j, ctx_j, jnp.asarray(WIN_END))
    ctx_t = types.SimpleNamespace(**flags, bw_dn=torch.from_numpy(bw),
                                  fault_down=torch.from_numpy(down),
                                  fault_up=torch.from_numpy(up))
    st_t = _State(
        convert._convert(_np_tree(st_j.evbuf),
                         lambda a: torch.from_numpy(np.array(a))),
        _Model(nic_t.NicState(*(torch.from_numpy(a) for a in nic))),
        _Metrics(torch.zeros((), dtype=torch.int64)))
    got = net_t.make_pre_window(ctx_t)(st_t, ctx_t, torch.tensor(WIN_END))
    assert int(got.metrics.down_events) == int(want.metrics.down_events) > 0
    _assert_same_leaves(_np_tree((want.evbuf, want.model.nic)),
                        jax.tree.map(lambda x: x.numpy(),
                                     (got.evbuf, got.model.nic)))


def _phold_churn_exp():
    exp = _phold_exp(n_hosts=8, end=40 * MS, latency=2 * MS)
    exp.faults = sched_t.FaultSchedule(
        host_id=[1, 1, 5], host_down=[5 * MS, 20 * MS, 11 * MS],
        host_up=[9 * MS, 26 * MS, NO_STOP])
    return exp


def test_dead_host_drop_accounting_matches_jax():
    """Dead-host event discards and delivery drops count as the JAX
    engine's, and every routed packet is accounted for."""
    ref = jax_reference(jax_experiment(_phold_churn_exp()), {}, 20, 8)
    mt, _ = assert_port_matches(ref, _phold_churn_exp(), {}, 20, 8)
    assert mt["down_pkts"] > 0 and mt["host_restarts"] == 2
    assert mt["pkts_sent"] == (mt["pkts_delivered"] + mt["pkts_lost"]
                               + mt["down_pkts"] + mt["link_down_pkts"])


def test_restart_resets_model_state():
    """A restarted host comes back with its post-init model state (PHOLD's
    draw counters and hops zeroed), as in the JAX engine; host 1, reset
    twice, ends with fewer hops than host 0."""
    ref = jax_reference(jax_experiment(_phold_churn_exp()), {}, 20, 11)
    _, summ = assert_port_matches(ref, _phold_churn_exp(), {}, 20, 11)
    hops = summ["hops"]
    assert hops[1] < hops[0]


def _outage_exp():
    h = 2
    exp = ct.single_vertex_experiment(
        n_hosts=h, seed=5, end_time=4 * SEC, latency_ns=20 * MS,
        model="net", bw_bits=10**7, model_cfg=dict(
            app="filexfer", role=np.array([0, 1]),
            server=np.zeros(h, np.int64),
            flow_bytes=np.full(h, 1_200_000, np.int64),
            start_time=np.full(h, 1 * MS, np.int64),
            flow_count=np.array([0, 1], np.int64)))
    exp.faults = sched_t.FaultSchedule(
        link_src=[0], link_dst=[0], link_t0=[300 * MS], link_t1=[500 * MS],
        ramp_src=[0], ramp_dst=[0], ramp_t0=[1200 * MS],
        ramp_t1=[1800 * MS], ramp_loss=[0.05])
    return exp


def test_tcp_flow_survives_link_outage_via_rto():
    """A 200 ms outage mid-transfer drops the window in flight; the sender
    recovers through its retransmit timer and completes the flow, and the
    loss ramp after it hits traffic — as in the JAX engine."""
    params = dict(ev_cap=256)
    ref = jax_reference(jax_experiment(_outage_exp()), params, 200, 20)
    mt, summ = assert_port_matches(ref, _outage_exp(), params, 200, 20)
    assert mt["link_down_pkts"] > 0 and mt["tcp_rto"] >= 1
    assert mt["pkts_lost"] > 0
    assert int(summ["total_flows_done"]) == 1


def _churn(windows):
    doc = _load("churn_filexfer.yaml")
    base = str(ROOT / "configs")
    exp_j, par_j, _ = xj.build_experiment(copy.deepcopy(doc), base_dir=base)
    exp_t, par_t, _ = xt.build_experiment(copy.deepcopy(doc), base_dir=base)
    params = {f.name: getattr(par_t, f.name)
              for f in dataclasses.fields(par_t)
              if getattr(par_t, f.name) != f.default}
    ref = jax_reference(exp_j, params, windows, windows // 2)
    return assert_port_matches(ref, exp_t, params, windows, windows // 2)


def test_churn_filexfer_prefix_matches_jax():
    """churn_filexfer.yaml to window 35: host 2 goes down at 800 ms
    (window 20) and restarts at 1.2 s (window 30)."""
    mt, _ = _churn(35)
    assert mt["host_restarts"] == 1 and mt["down_pkts"] > 0


@pytest.mark.slow
def test_churn_filexfer_whole_matches_jax():
    """churn_filexfer.yaml whole (150 windows): three restarts, the link
    outage at 3 s and the loss ramp after it."""
    mt, summ = _churn(150)
    assert mt["host_restarts"] == 3 and mt["link_down_pkts"] > 0
    assert int(summ["total_flows_done"]) > 0

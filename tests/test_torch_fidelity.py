"""The port's fidelity gates against the JAX package, on the CPU.

The cases of ``tests/test_fidelity.py``, each with a value that fires:
edge jitter, host stop times (churn), the virtual CPU (whose deferrals go
back through ``popk.push_back``), drop-tail NIC queues and RED AQM (on
TCP's sends, and on ``udp_send``'s in a dgram ring), and one more case with every gate on at once under active-host compaction
(``fidelity_filexfer_experiment``, the card golden's layout at two
tiles). The port's ``Engine(device="cpu")`` must equal the JAX ``Engine``
bit for bit: every ``Metrics`` field, every summary array, every ring row
(the per-window digest words included) and every state leaf, at a mid-run
window and at the end. Each case asserts that its gate fired. The RED
coin and the Q16 drop threshold of ``nic.tx_stamp`` are held to the
reference's on random rows, at the ramp's edges.

``jax_experiment`` (a port experiment as the JAX package's, its fault
schedule included) serves ``test_torch_fault.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shadow1_tpu.config import compiled as cj
from shadow1_tpu.fault.schedule import FaultSchedule as FaultScheduleJ
from shadow1_tpu.net import nic as nic_j
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.net import nic as nic_t
from tests.test_torch_tgen import (  # noqa: F401  (fixture)
    _one_thread,
    assert_port_matches,
    jax_reference,
)

MS, SEC = 10**6, 10**9


def jax_experiment(exp):
    """The port's CompiledExperiment as the JAX package's (the fault
    schedule as its own ``FaultSchedule``)."""
    out = cj.CompiledExperiment(**{
        f.name: getattr(exp, f.name)
        for f in dataclasses.fields(cj.CompiledExperiment)})
    out.model_cfg = dict(exp.model_cfg)
    if exp.faults is not None:
        out.faults = FaultScheduleJ(**dataclasses.asdict(exp.faults))
    return out


def _phold(n=64, end=80 * MS, **kw):
    return ct.single_vertex_experiment(
        n_hosts=n, seed=5, end_time=end, latency_ns=2 * MS, model="phold",
        model_cfg={"mean_delay_ns": float(3 * MS), "init_events": 2}, **kw)


def _filexfer(n=6, qlen=0, end=30 * SEC):
    role = np.full(n, 1, np.int64)
    role[0] = 0
    fid = {}
    if qlen:
        fid = {"tx_qlen_bytes": np.full(n, qlen, np.int64),
               "rx_qlen_bytes": np.full(n, qlen, np.int64)}
    return ct.single_vertex_experiment(
        n_hosts=n, seed=9, end_time=end, latency_ns=10 * MS, bw_bits=10**6,
        model="net", model_cfg={
            "app": "filexfer", "role": role,
            "server": np.zeros(n, np.int64),
            "flow_bytes": np.full(n, 60_000, np.int64),
            "start_time": np.full(n, 1 * MS, np.int64),
            "flow_count": np.where(role == 1, 1, 0)}, **fid)


def _red(n=6, end=30 * SEC):
    exp = _filexfer(n, end=end)
    exp.aqm_min_bytes = np.full(n, 2_000, np.int64)
    exp.aqm_max_bytes = np.full(n, 12_000, np.int64)
    exp.aqm_pmax = np.full(n, 0.3, np.float64)
    return exp


def _dgram_queues(n=16):
    """A dgram ring sending faster than its 10 Mbit uplinks drain:
    ``udp_send``'s tx stamp under RED and the uplink bound."""
    exp = ct.dgram_ring_experiment(n, 5, 30 * 10 * MS, latency_ns=10 * MS,
                                   loss=0.0, payload=1200,
                                   interval=MS // 2, count=40,
                                   start_time=1 * MS)
    exp.bw_up = np.full(n, 10**7, np.int64)
    exp.tx_qlen_bytes = np.full(n, 6_000, np.int64)
    exp.aqm_min_bytes = np.full(n, 1_000, np.int64)
    exp.aqm_max_bytes = np.full(n, 8_000, np.int64)
    exp.aqm_pmax = np.full(n, 0.3, np.float64)
    return exp


def _stop():
    stop = np.full(64, ct.NO_STOP, np.int64)
    stop[::2] = 30 * MS  # half the hosts die mid-run
    return _phold(stop_time=stop)


def _cpu():
    cost = np.zeros(64, np.int64)
    cost[:32] = 500_000  # 0.5 ms of virtual CPU per event on half the hosts
    return _phold(cpu_ns_per_event=cost)


# name -> (experiment, engine params, windows, mid, metrics that must be
# > 0). The filexfer cases run to the windows by which every flow is done
# (10 ms windows), not the reference's 30 s.
CASES = {
    "jitter": (lambda: _phold(jitter_ns=1 * MS), dict(ev_cap=64), 80, 30,
               ("events",)),
    "stop_time": (_stop, dict(ev_cap=64), 40, 14,
                  ("down_events", "down_pkts")),
    "virtual_cpu": (_cpu, dict(ev_cap=64), 40, 14, ("events",)),
    "nic_queues": (lambda: _filexfer(qlen=3000, end=10 * SEC),
                   dict(ev_cap=256), 1000, 400,
                   ("nic_tx_drops", "nic_rx_drops", "fires_pkt")),
    "red_aqm": (lambda: _red(end=6 * SEC), dict(ev_cap=256), 600, 250,
                ("nic_aqm_drops",)),
    "dgram_queues": (_dgram_queues, dict(), 30, 10,
                     ("nic_tx_drops", "nic_aqm_drops")),
    "all_compacted": (lambda: ct.fidelity_filexfer_experiment(
                          2, 42, 400 * MS),
                      dict(ev_cap=512, compact_cap=8), 11, 6,
                      ("nic_tx_drops", "nic_rx_drops", "nic_aqm_drops",
                       "down_pkts", "link_down_pkts", "host_restarts",
                       "fires_pkt")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fidelity_matches_jax(name, monkeypatch):
    from shadow1_tpu_torch.core import compact, popk

    monkeypatch.setattr(compact, "WINDOWS", {"compact": 0, "full": 0})
    deferred = []
    push_back = popk.push_back

    def counting_push_back(buf, mask, *args):
        deferred.append(int(mask.sum()))
        return push_back(buf, mask, *args)

    monkeypatch.setattr(popk, "push_back", counting_push_back)
    make, params, windows, mid, fired = CASES[name]
    ref = jax_reference(jax_experiment(make()), params, windows, mid)
    mt, summ = assert_port_matches(ref, make(), params, windows, mid)
    assert all(mt[k] > 0 for k in fired), {k: mt[k] for k in fired}
    # push_back runs every round under the virtual CPU, and only there.
    has_cpu = name in ("virtual_cpu", "all_compacted")
    assert len(deferred) == (mt["rounds"] if has_cpu else 0)
    if has_cpu:
        assert sum(deferred) > 0
    if name == "jitter":
        # The jitter shrinks the window to 1 ms, and the run differs from
        # the one without it.
        base = jax_reference(jax_experiment(_phold()), params, 40, 20)
        assert make().window == 1 * MS
        assert ref.metrics["events"] != base.metrics["events"]
    if name == "virtual_cpu":
        # Busy hosts carry a CPU clock and serialize their events: fewer
        # fit in the same time than without the cost.
        assert (ref.end.cpu_busy[:32] > 0).all()
        free = jax_reference(jax_experiment(_phold()), params, windows, mid)
        assert mt["events"] < free.metrics["events"]
    if name in ("nic_queues", "red_aqm"):
        assert int(summ["total_flows_done"]) == 5   # flows survive drops
    if name == "red_aqm":
        assert mt["nic_tx_drops"] == 0 and mt["nic_rx_drops"] == 0
    if name == "all_compacted":
        assert mt["host_restarts"] == 3 * 2
        assert compact.WINDOWS["compact"] > 0


def _red_rows(g, h):
    """NIC state and RED tables on h hosts whose backlogs fall below, in
    and past the [min, min + span) ramp, and on its edges."""
    tx_free = g.integers(0, 2**40, h)
    now = tx_free - g.integers(-10**6, 4 * 10**7, h)
    min_ns = g.integers(0, 10**7, h)
    span_ns = g.integers(1, 3 * 10**7, h)
    edge = g.integers(0, 4, h)
    backlog = np.select([edge == 0, edge == 1, edge == 2],
                        [min_ns, min_ns + span_ns, min_ns + span_ns - 1],
                        np.maximum(tx_free - now, 0))
    now = np.where(edge < 3, tx_free - backlog, now)
    pmax = g.choice(np.array([0.0, 0.05, 0.3, 1.0]), h)
    thr = np.round(pmax * 2.0**32).astype(np.uint64)
    nic = [tx_free, g.integers(0, 2**40, h), g.integers(0, 2**30, h),
           g.integers(0, 2**30, h), g.integers(0, 2**20, h)]
    return nic, now, min_ns, span_ns, thr


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("bounded", [False, True])
def test_red_tx_stamp_matches_jax(seed, bounded):
    """``tx_stamp`` with RED (and the drop-tail bound after it) on random
    rows: the nic state (``aqm_ctr`` included), departures, ok and red
    masks equal the reference's, and both gates drop somewhere."""
    import torch

    g = np.random.default_rng(seed)
    h = 4099
    nic, now, min_ns, span_ns, thr = _red_rows(g, h)
    mask = g.random(h) < 0.8
    wire = g.integers(40, 1600, h)
    bw = g.choice(np.array([10**6, 10**7, 10**9]), h)
    qlen = g.integers(0, 3 * 10**7, h) if bounded else None
    key, hosts = 0x1234ABCD, np.arange(h, dtype=np.int32)
    t = torch.from_numpy
    want = nic_j.tx_stamp(
        nic_j.NicState(*(jnp.asarray(a) for a in nic)), jnp.asarray(mask),
        jnp.asarray(wire), jnp.asarray(now), jnp.asarray(bw),
        None if qlen is None else jnp.asarray(qlen),
        aqm=(jnp.asarray(key, jnp.uint64), jnp.asarray(hosts),
             jnp.asarray(min_ns), jnp.asarray(span_ns), jnp.asarray(thr)))
    got = nic_t.tx_stamp(
        nic_t.NicState(*(t(a) for a in nic)), t(mask), t(wire), t(now),
        t(bw), None if qlen is None else t(qlen),
        aqm=(key, t(hosts), t(min_ns), t(span_ns), t(thr.astype(np.int64))))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            jax.tree.map(lambda x: x.numpy(), got))):
        np.testing.assert_array_equal(b, np.asarray(a))
    red, ok = got[3].numpy(), got[2].numpy()
    assert red.any() and (mask & ~red & ~ok).any() == bounded

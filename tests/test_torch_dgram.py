"""The port's dgram app and ``udp_send`` against the JAX package, on the
CPU.

A 24-host datagram mesh with 5 % path loss on 10 Mbit links: every host
sends 1,200-byte datagrams every 0.5 ms, faster than its uplink
serializes them, to a destination drawn from a numpy seed (several
senders share a destination), so the NIC's uplink and downlink queues,
the loss draws and the dgram notify path all run. The port's
``Engine(device="cpu")`` must equal the JAX ``Engine`` bit for bit (every
``Metrics`` field, summary array, ring row with its digest words, and
state leaf), also from a JAX state carried across mid-run. ``udp_send``
alone, on a random state, must equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow1_tpu import net as net_j
from shadow1_tpu.config.compiled import single_vertex_experiment
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu_torch import convert
from shadow1_tpu_torch import net as net_t
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.engine import Engine as EngineT
from tests.test_torch_tgen import (
    assert_carried,
    assert_port_matches,
    assert_same_leaves,
    jax_reference,
    port_experiment,
)

MS = 1_000_000
WINDOWS, MID = 12, 5
PARAMS = dict(ev_cap=128, outbox_cap=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n=24, seed=13):
    g = np.random.default_rng(seed)
    dst = (np.arange(n) + g.integers(1, n, n)) % n   # never itself
    return single_vertex_experiment(
        n_hosts=n, seed=seed, end_time=WINDOWS * 10 * MS, latency_ns=10 * MS,
        loss=0.05, bw_bits=10_000_000, model="net", model_cfg={
            "app": "dgram",
            "dst": dst.astype(np.int64),
            "payload": np.full(n, 1200, np.int64),
            "interval": np.full(n, MS // 2, np.int64),
            "count": g.integers(0, 40, n).astype(np.int64),
            "start_time": g.integers(0, 5 * MS, n).astype(np.int64),
        })


@pytest.fixture(scope="module")
def jax_run():
    return jax_reference(_mesh(), PARAMS, WINDOWS, MID)


def test_dgram_matches_jax(jax_run):
    mt, summ = assert_port_matches(jax_run, port_experiment(_mesh()), PARAMS,
                                   WINDOWS, MID)
    assert mt["pkts_lost"] > 0 and mt["pops_deliver"] > 0
    assert int(summ["total_rx"]) == mt["pkts_delivered"] > 0
    # The uplinks queue: the NIC clocks ran past the send times.
    assert int(summ["nic_tx_bytes"].sum()) > 0


def test_dgram_state_carried_from_jax(jax_run):
    assert_carried(jax_run, port_experiment(_mesh()), PARAMS, WINDOWS, MID)


def test_udp_send_matches_jax():
    """``udp_send`` on a random state — NIC clocks behind and ahead of
    ``now``, outboxes empty, partly full and full, packet counters past
    2**31 — with random masks, destinations, sockets, lengths and metas."""
    g = np.random.default_rng(29)
    exp = _mesh(n=64)
    eng_j = EngineJ(exp, EngineParamsJ(**PARAMS))
    eng_t = EngineT(port_experiment(exp), EngineParamsT(**PARAMS),
                    device="cpu")
    tree = jax.tree.map(np.asarray, eng_j.init_state())
    h, cap = exp.n_hosts, PARAMS["outbox_cap"]
    now = g.integers(0, 50 * MS, h).astype(np.int64)
    nic = tree.model.nic._replace(
        tx_free=now + g.integers(-5 * MS, 5 * MS, h),
        tx_bytes=g.integers(0, 2**40, h))
    cnt = g.integers(0, cap + 1, h).astype(np.int32)
    cnt[:8] = cap
    ob = tree.outbox._replace(
        cnt=cnt, pkt_ctr=g.integers(0, 2**33, h).astype(np.int64))
    tree = tree._replace(model=tree.model._replace(nic=nic), outbox=ob)
    args = [g.random(h) < 0.7,                                   # mask
            g.integers(0, h, h).astype(np.int32),                # dst_host
            g.integers(0, 16, h).astype(np.int32),               # dst_sock
            g.integers(0, 1500, h).astype(np.int32),             # length
            g.integers(-2**31, 2**31, h).astype(np.int32),       # meta
            g.integers(-2**31, 2**31, h).astype(np.int32),       # meta2
            now]
    st_j = net_j.udp_send(jax.tree.map(jnp.asarray, tree), eng_j.ctx,
                          *map(jnp.asarray, args))
    st_t = net_t.udp_send(convert.state_from_numpy(tree, "cpu"), eng_t.ctx,
                          *(torch.from_numpy(a) for a in args))
    want = jax.tree.map(np.asarray, st_j)
    assert int(want.metrics.ob_overflow) > 0
    assert_same_leaves(want, convert.state_to_numpy(st_t))

"""The port's C++ thread-per-core comparator (``shadow1_tpu_torch/native/``)
against the port's numpy oracle and the JAX package's comparator.

The comparator is the baseline a benchmark divides by, and counter
equality with the oracle (itself bit-exact with both packages' engines,
``tests/test_torch_oracle.py``) is what entitles it to that role. Cases:
PHOLD with 1 and 4 worker threads; the net comparator on a lossy
filexfer, a Tor network and a Bitcoin gossip network; the refusal of every
fidelity knob it does not model and of the dgram app. The JAX package's
comparator runs on the same experiments from a build directory of this
test's own, so it never races that package's own tests for its binary.
Exact counters throughout.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

import shadow1_tpu.native as native_j
from shadow1_tpu_torch import native as native_t
from shadow1_tpu_torch import rng as rng_t
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.consts import EngineParams
from shadow1_tpu_torch.cpu_engine import CpuEngine
from shadow1_tpu_torch.fault.schedule import FaultSchedule
from tests.test_torch_fidelity import jax_experiment

MS, SEC = 10**6, 10**9
PHOLD_KEYS = ("events", "pkts_sent", "pkts_delivered", "ev_overflow",
              "ob_overflow")
NET_KEYS = (
    "events", "pkts_sent", "pkts_delivered", "pkts_lost", "ev_overflow",
    "ob_overflow", "tcp_fast_rtx", "tcp_rto", "tcp_ooo_drops",
    "pops_deliver", "pops_timer", "pops_txr", "pops_app",
)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's comparator module, building into a directory of
    this module's own."""
    d = tmp_path_factory.mktemp("native_jax")
    names = {"_BUILD": d, "_BIN": d / "phold_comparator",
             "_NET_BIN": d / "net_comparator", "_TABLE": d / "log2_q32.tbl"}
    old = {k: getattr(native_j, k) for k in names}
    for k, v in names.items():
        setattr(native_j, k, v)
    yield native_j
    for k, v in old.items():
        setattr(native_j, k, v)


def _phold(n_hosts=256, windows=40, init=3):
    exp = ct.single_vertex_experiment(
        n_hosts=n_hosts, seed=77, end_time=windows * MS, latency_ns=1 * MS,
        model="phold",
        model_cfg={"mean_delay_ns": float(2 * MS), "init_events": init})
    return exp, EngineParams(ev_cap=32, outbox_cap=16, max_rounds=64), windows


def _phold_args(exp, params, windows, n_threads):
    return dict(n_hosts=exp.n_hosts, seed=exp.seed, n_windows=windows,
                window_ns=exp.window,
                mean_delay_ns=exp.model_cfg["mean_delay_ns"],
                init_events=exp.model_cfg["init_events"],
                ev_cap=params.ev_cap, outbox_cap=params.outbox_cap,
                n_threads=n_threads)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_phold_matches_oracle_and_jax_comparator(jax_native, n_threads):
    exp, params, windows = _phold()
    cm = CpuEngine(exp, params).run(n_windows=windows)
    assert cm["ev_overflow"] == 0 and cm["ob_overflow"] == 0
    args = _phold_args(exp, params, windows, n_threads)
    nt = native_t.run_phold(**args)
    nj = jax_native.run_phold(**args)
    assert nt["n_threads"] == n_threads
    for k in PHOLD_KEYS:
        assert nt[k] == cm[k] == nj[k], (k, nt[k], cm[k], nj[k])
    assert nt["events"] > 0 and nt["wall_s"] > 0


def _compare_net(jax_native, exp, params, windows, summary_keys,
                 n_threads=2):
    cpu = CpuEngine(exp, params)
    cm = cpu.run(n_windows=windows)
    cs = cpu.summary()
    nt = native_t.run_net(exp, params, windows, n_threads=n_threads)
    nj = jax_native.run_net(jax_experiment(exp), params, windows,
                            n_threads=n_threads)
    for k in NET_KEYS:
        assert nt[k] == cm[k] == nj[k], (k, nt[k], cm[k], nj[k])
    for k in summary_keys:
        want = cs[k]
        want = int(want if np.ndim(want) == 0 else np.asarray(want).sum())
        assert int(nt[k]) == want == int(nj[k]), (k, nt[k], want, nj[k])
    return cm


def _filexfer(n=8, loss=0.01, end=20 * SEC, **kw):
    role = np.full(n, 1, np.int64)
    role[0] = 0
    return ct.single_vertex_experiment(
        n_hosts=n, seed=3, end_time=end, latency_ns=10 * MS, loss=loss,
        bw_bits=10**7, model="net", model_cfg={
            "app": "filexfer", "role": role, "server": np.zeros(n, np.int64),
            "flow_bytes": np.full(n, 30_000, np.int64),
            "start_time": np.full(n, MS, np.int64),
            "flow_count": np.where(role == 1, 1, 0)}, **kw)


def test_net_filexfer_lossy(jax_native):
    cm = _compare_net(jax_native, _filexfer(), EngineParams(ev_cap=256), 2000,
                      ("total_flows_done", "total_rx_bytes"))
    assert cm["pkts_lost"] > 0


def test_net_tor(jax_native):
    exp = ct.tor_experiment(
        n_guard=6, n_middle=8, n_exit=6, n_dirauth=2, n_client=40, seed=11,
        end_time=400 * 30 * MS, latency_ns=30 * MS, relay_bw=200_000_000,
        client_bw=20_000_000, n_circuits=2, n_streams=3,
        mean_stream_cells=40.0, mean_think_ns=500.0 * MS, start_time=100 * MS)
    cm = _compare_net(jax_native, exp, EngineParams(ev_cap=256,
                                                    sockets_per_host=32), 400,
                      ("total_streams_done", "total_cells_fwd",
                       "total_cells_rx", "clients_done",
                       "total_ct_overflow"))
    assert cm["pops_deliver"] > 0


def test_net_bitcoin(jax_native):
    exp = ct.bitcoin_experiment(
        64, seed=5, end_time=60 * 50 * MS, latency_ns=50 * MS,
        bw_bits=50_000_000, k=8, n_tx=20, tx_start=500 * MS,
        tx_interval=100 * MS)
    _compare_net(jax_native, exp, EngineParams(ev_cap=256), 60,
                 ("total_seen", "total_tx_rx"))


def _fault(exp):
    exp.faults = FaultSchedule(host_id=[1], host_down=[100 * MS],
                               host_up=[200 * MS])
    return exp


# Each knob the net comparator does not model, and the word it names.
REFUSED = {
    "virtual CPU": lambda: _filexfer(
        4, 0.0, 2 * SEC, cpu_ns_per_event=np.full(4, 100, np.int64)),
    "host stop times": lambda: _filexfer(
        4, 0.0, 2 * SEC, stop_time=np.array([1 << 62, SEC, 1 << 62, 1 << 62])),
    "tx queue bound": lambda: _filexfer(
        4, 0.0, 2 * SEC, tx_qlen_bytes=np.full(4, 10_000, np.int64)),
    "rx queue bound": lambda: _filexfer(
        4, 0.0, 2 * SEC, rx_qlen_bytes=np.full(4, 10_000, np.int64)),
    "RED AQM": lambda: _filexfer(
        4, 0.0, 2 * SEC, aqm_min_bytes=np.full(4, 1_000, np.int64),
        aqm_max_bytes=np.full(4, 5_000, np.int64),
        aqm_pmax=np.full(4, 0.1)),
    "fault schedule": lambda: _fault(_filexfer(4, 0.0, 2 * SEC)),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_refuses_unmodeled_fidelity(what):
    with pytest.raises(native_t.NativeUnavailable, match=what):
        native_t.run_net(REFUSED[what](), EngineParams(), 10)


def test_refuses_dgram():
    exp = ct.dgram_ring_experiment(
        8, seed=1, end_time=10 * MS, latency_ns=MS, loss=0.0, payload=100,
        interval=MS, count=2, start_time=MS)
    with pytest.raises(native_t.NativeUnavailable,
                       match="unknown app 'dgram'"):
        native_t.run_net(exp, EngineParams(), 10)


def test_table_is_the_port_rng_and_builds_do_not_race(tmp_path):
    """The dumped table is the port's Q32 log2 table and ln2; two
    processes forcing a rebuild at once both finish with a whole binary
    (each compiles to its own name, then renames)."""
    native_t.ensure_built()
    raw = native_t._TABLE.read_bytes()
    want = (np.asarray(rng_t._LOG_TBL_NP, np.uint64).tobytes()
            + np.uint64(rng_t._LN2_Q32).tobytes())
    assert raw == want
    code = ("from shadow1_tpu_torch import native; "
            "native.ensure_built(force=True)")
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              cwd=native_t._REPO,
                              env={**os.environ, "PYTHONPATH":
                                   str(native_t._REPO)})
             for _ in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    assert not list(native_t._BUILD.glob(".*.tmp"))
    exp, params, windows = _phold(64, 10, 2)
    cm = CpuEngine(exp, params).run(n_windows=windows)
    got = native_t.run_phold(**_phold_args(exp, params, windows, 2))
    assert all(got[k] == cm[k] for k in PHOLD_KEYS)

"""The port's numpy oracle (``shadow1_tpu_torch/cpu_engine/``) against the
JAX package's, and against the port's own batched ``Engine``, on the CPU.

Each case builds one experiment in both packages (the YAML configs
through each package's loader; the in-code ones through the port's
builders, carried across with ``test_torch_fidelity.jax_experiment``) and
runs both oracles with the digest words and the work rows on: every
metric, every summary array and every digest, work, flow and link row
must be equal. The cases cover PHOLD, lossy PHOLD, rung 1, rung 2, rung 3
Tor, dgram, Bitcoin, ``churn_filexfer.yaml`` with its faults, every
fidelity knob at once (NIC queue bounds, RED, the virtual CPU, jitter,
the fault plane), flow probes with the link accumulator, the self-check,
the pcap capture hook and the halt on a fresh overflow.

The oracle contract inside the port: on a few of those cases the port's
``Engine(device="cpu")`` must give the same metrics (the oracle's keys),
summary arrays, digest words (its ring's ``dg_*`` columns), work gauges,
flow rows and link rows as the port's oracle. Bit-exact throughout.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from shadow1_tpu.config import experiment as xj
from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.cpu_engine import CpuEngine as CpuEngineJ
from shadow1_tpu.txn import CapacityExceededError as CapErrJ
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config import experiment as xt
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.digest import DIGEST_FIELDS
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.cpu_engine import CpuEngine as CpuEngineT
from shadow1_tpu_torch.telemetry.links import drain_links
from shadow1_tpu_torch.telemetry.probes import drain_probes
from shadow1_tpu_torch.telemetry.ring import drain_ring
from shadow1_tpu_torch.txn import CapacityExceededError as CapErrT
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import _one_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
MS, SEC = 10**6, 10**9
WORK_FIELDS = ("active_hosts", "elig_events", "outbox_hosts")


def _phold(loss: float = 0.0, n: int = 64, windows: int = 30):
    return ct.single_vertex_experiment(
        n_hosts=n, seed=5, end_time=windows * 2 * MS, latency_ns=2 * MS,
        loss=loss, model="phold",
        model_cfg={"mean_delay_ns": float(3 * MS), "init_events": 2})


def _yaml(name: str):
    """(port exp, JAX exp, params dict) from one YAML config."""
    path = str(ROOT / "configs" / name)
    exp_t, p_t, _ = xt.load_experiment(path)
    exp_j, _, _ = xj.load_experiment(path)
    return exp_t, exp_j, dataclasses.asdict(p_t)


def _built(exp_t, **params):
    return exp_t, jax_experiment(exp_t), params


# name -> (builder, windows, params added to the builder's)
CASES = {
    "phold": (lambda: _built(_phold()), 30, {}),
    "phold_lossy": (lambda: _built(_phold(loss=0.1)), 30, {}),
    "rung1": (lambda: _yaml("rung1_filexfer.yaml"), 60, {}),
    "rung2": (lambda: _yaml("rung2_tgen100.yaml"), 40, {}),
    "rung3_tor": (lambda: _yaml("rung3_tor1k.yaml"), 25, {}),
    "dgram": (lambda: _built(ct.dgram_ring_experiment(
        32, seed=7, end_time=20 * 10 * MS, latency_ns=10 * MS, loss=0.05,
        payload=1200, interval=2 * MS, count=20, start_time=1 * MS)), 20, {}),
    "bitcoin": (lambda: _built(ct.bitcoin_experiment(
        100, seed=55, end_time=40 * 50 * MS, latency_ns=50 * MS,
        bw_bits=50_000_000, k=8, n_tx=20, tx_start=500 * MS,
        tx_interval=100 * MS), ev_cap=96, sockets_per_host=32, msgq_cap=64,
        max_rounds=1024), 40, {}),
    "churn": (lambda: _yaml("churn_filexfer.yaml"), 150, {}),
    "fidelity": (lambda: _built(ct.fidelity_filexfer_experiment(
        2, seed=42, end_time=400 * MS), ev_cap=512), 11, {}),
    "probes_links": (lambda: _yaml("rung1_filexfer.yaml"), 15,
                     {"probes": ((1, 0), (0, -1), (1, -1)),
                      "link_telem": 1}),
    "selfcheck": (lambda: _built(_phold(loss=0.1)), 30,
                  {"selfcheck": 1, "on_overflow": "halt"}),
}
# The cases the port's batched engine runs too (the slow ones stay out).
ENGINE_CASES = ("phold", "phold_lossy", "dgram", "fidelity", "probes_links")


def _setup(name: str):
    build, windows, extra = CASES[name]
    exp_t, exp_j, params = build()
    params = {**params, **extra, "state_digest": 1, "metrics_ring": windows}
    return exp_t, exp_j, params, windows


def _summary_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert type(x) is type(y) and x == y, k


def _rows(eng) -> dict:
    return {k: getattr(eng, k) for k in ("digest_rows", "work_rows",
                                         "probe_rows", "link_rows")}


@pytest.fixture(scope="module")
def oracles():
    """name -> (port oracle, exp, params, windows), each held to the JAX
    oracle on the way."""
    runs = {}

    def get(name):
        if name not in runs:
            exp_t, exp_j, params, windows = _setup(name)
            ot = CpuEngineT(exp_t, EngineParamsT(**params))
            oj = CpuEngineJ(exp_j, EngineParamsJ(**params))
            mt, mj = ot.run(n_windows=windows), oj.run(n_windows=windows)
            assert list(mt) == list(mj) and mt == mj
            _summary_equal(ot.summary(), oj.summary())
            rt, rj = _rows(ot), _rows(oj)
            for k in rt:
                assert rt[k] == rj[k], k
            assert len(rt["digest_rows"]) == windows
            assert len(rt["work_rows"]) == windows
            runs[name] = (ot, exp_t, params, windows)
        return runs[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_matches_jax_oracle(oracles, name):
    ot, _, params, windows = oracles(name)
    m = ot.metrics
    assert m["events"] > 0 and m["ev_overflow"] == 0 and m["ob_overflow"] == 0
    if name == "phold_lossy":
        assert m["pkts_lost"] > 0
    if name == "churn":
        assert m["host_restarts"] > 0 and m["down_pkts"] > 0
        assert m["link_down_pkts"] > 0
    if name == "fidelity":
        for k in ("nic_tx_drops", "nic_rx_drops", "nic_aqm_drops",
                  "down_pkts", "link_down_pkts", "host_restarts"):
            assert m[k] > 0, k
    if name == "rung3_tor":
        assert m["pops_deliver"] > 0
    if name == "bitcoin":
        assert int(np.asarray(ot.summary()["total_seen"])) > 0
    if name == "probes_links":
        assert len(ot.probe_rows) == windows * len(params["probes"])
        assert any(r["cwnd"] > 0 for r in ot.probe_rows if r["sock"] == 0)
        assert any(r["pkts"] > 0 for r in ot.link_rows)


@pytest.mark.parametrize("name", ENGINE_CASES)
def test_oracle_matches_port_engine(oracles, name):
    """The oracle contract inside the port: the batched engine on the CPU
    gives what the oracle gives."""
    ot, exp, params, windows = oracles(name)
    eng = EngineT(exp, EngineParamsT(**params), device="cpu")
    st = eng.run(n_windows=windows)
    m = EngineT.metrics_dict(st)
    assert {k: m[k] for k in ot.metrics} == ot.metrics
    summ = eng.model_summary(st)
    for k, v in ot.summary().items():
        np.testing.assert_array_equal(np.asarray(summ[k]), np.asarray(v),
                                      err_msg=k)
    ring = [r for r in drain_ring(st, eng.window) if r["type"] == "ring"]
    assert [{"type": "digest", "window": r["window"],
             **{f: r[f] for f in DIGEST_FIELDS}} for r in ring] \
        == ot.digest_rows
    assert [{"type": "work", "window": r["window"],
             **{f: r[f] for f in WORK_FIELDS}} for r in ring] == ot.work_rows

    def key(r):
        return tuple(r.get(k, -1) for k in ("window", "host", "sock",
                                             "src_vertex", "dst_vertex"))

    if params.get("probes"):
        got = drain_probes(st, eng.window, tuple(params["probes"]))
        assert sorted(got, key=key) == sorted(ot.probe_rows, key=key)
    if params.get("link_telem"):
        got = drain_links(st, eng.window)
        assert sorted(got, key=key) == sorted(ot.link_rows, key=key)


def test_capture_matches_jax():
    """The pcap hook sees the same packets, in the same order, on both
    oracles (delivered, lost and link-down ones)."""
    exp_t, exp_j, params = _yaml("churn_filexfer.yaml")
    got, want = [], []
    CpuEngineT(exp_t, EngineParamsT(**params),
               capture=lambda *a: got.append(a)).run(n_windows=60)
    CpuEngineJ(exp_j, EngineParamsJ(**params),
               capture=lambda *a: want.append(a)).run(n_windows=60)
    assert got == want
    assert any(a[-1] for a in got) and any(not a[-1] for a in got)


def test_oracle_halt_same_boundary_check():
    """The twin of the JAX package's ``test_cpu_oracle_halt_same_boundary
    _check``: the 8-host PHOLD that overflows ev_cap 8 halts on both
    oracles at the same window with the same structured error."""
    exp_t = ct.single_vertex_experiment(
        n_hosts=8, seed=5, end_time=40 * MS, latency_ns=1 * MS,
        model="phold", model_cfg={"mean_delay_ns": float(2 * MS),
                                  "init_events": 6})
    params = {"ev_cap": 8, "on_overflow": "halt"}
    with pytest.raises(CapErrT) as et:
        CpuEngineT(exp_t, EngineParamsT(**params)).run(n_windows=40)
    with pytest.raises(CapErrJ) as ej:
        CpuEngineJ(jax_experiment(exp_t), EngineParamsJ(**params)).run(
            n_windows=40)
    e = et.value
    assert e.knob == "ev_cap" and e.overflow > 0
    assert e.window_range[1] - e.window_range[0] == 1
    for f in ("knob", "counter", "cap", "overflow", "window_range",
              "recommended"):
        assert getattr(e, f) == getattr(ej.value, f), f
    assert str(e) == str(ej.value).replace("shadow1_tpu.", "shadow1_tpu_torch.")


def test_tables_are_not_cached_in_model_cfg():
    """The oracle and the batched engine share one CompiledExperiment
    without leaving keys in its model config (the reference memoizes Tor's
    tables there)."""
    exp_t, _, params = _yaml("rung3_tor1k.yaml")
    keys = set(exp_t.model_cfg)
    CpuEngineT(exp_t, EngineParamsT(**params)).run(n_windows=2)
    EngineT(exp_t, EngineParamsT(**params), device="cpu")
    assert set(exp_t.model_cfg) == keys


def test_oracle_imports_neither_jax_nor_the_reference():
    """The oracle, the comparator and the tools on them, imported in a
    fresh process, load no module of JAX or of the JAX package."""
    import subprocess
    import sys

    mods = ["cpu_engine", "native", "cli"] + [
        f"tools.{t}" for t in ("pcapdump", "fleetprobe", "activeprobe",
                               "depthprobe", "occprobe", "chaosprobe")]
    code = ("import sys\n"
            + "".join(f"import shadow1_tpu_torch.{m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'shadow1_tpu')]\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]

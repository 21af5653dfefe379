"""The pre-flight estimate builds a small state on the host and a large one
on the meta device (``mem._init_device``); both give the same estimate.

For rung 1, the serve PHOLD, the 4-lane sweep as a fleet, rung 3 Tor and
a Bitcoin network (each small enough for the host path) the estimate
built on the host must equal, plane for plane and peak for peak, the one
built on the meta device; a large config (dense_tgen50k's 50,000 hosts)
takes the meta path; and a host-path estimate in a fresh process never
imports ``torch._dynamo`` (a process's first meta-device op does).
Exact (byte counts).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

from shadow1_tpu_torch import mem
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config.experiment import load_experiment
from shadow1_tpu_torch.fleet.expand import load_sweep

ROOT = Path(__file__).resolve().parents[1]
MS = 10**6


def _case(name):
    if name == "sweep_fleet":
        plan = load_sweep(str(ROOT / "configs" / "sweep_phold.yaml"))
        return plan.exps[0], plan.params, (plan.exps, plan.max_rounds)
    if name == "bitcoin":
        from shadow1_tpu_torch.consts import EngineParams

        exp = ct.bitcoin_experiment(
            100, seed=55, end_time=40 * 50 * MS, latency_ns=50 * MS,
            bw_bits=50_000_000, k=8, n_tx=20, tx_start=500 * MS,
            tx_interval=100 * MS)
        return exp, EngineParams(ev_cap=96, sockets_per_host=32), None
    exp, params, _ = load_experiment(str(ROOT / "configs" / name))
    return exp, params, None


@pytest.mark.parametrize("name", ["rung1_filexfer.yaml", "serve_phold.yaml",
                                  "sweep_fleet", "rung3_tor1k.yaml",
                                  "bitcoin", "churn_filexfer.yaml"])
def test_host_and_meta_estimates_agree(monkeypatch, name):
    exp, params, fleet = _case(name)
    host = mem.estimate(exp, params, fleet=fleet)
    monkeypatch.setattr(mem, "_init_device", lambda *a, **k: "meta")
    meta = mem.estimate(exp, params, fleet=fleet)
    assert host.planes == meta.planes and host.peaks == meta.peaks
    assert (host.evbuf_per_cap, host.outbox_per_cap, host.telem_per_w,
            host.n_exp) == (meta.evbuf_per_cap, meta.outbox_per_cap,
                            meta.telem_per_w, meta.n_exp)


def test_device_choice():
    small = _case("rung1_filexfer.yaml")
    assert mem._init_device(small[0], small[1]) == "cpu"
    exp, params, _ = load_experiment(str(ROOT / "configs"
                                         / "dense_tgen50k.yaml"))
    assert mem._init_device(exp, params) == "meta"


def test_host_path_skips_the_dynamo_import():
    code = ("import sys\nfrom shadow1_tpu_torch import mem\n"
            "from shadow1_tpu_torch.config.experiment import load_experiment\n"
            "exp, p, _ = load_experiment('configs/rung1_filexfer.yaml')\n"
            "mem.estimate(exp, p)\n"
            "assert 'torch._dynamo' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]

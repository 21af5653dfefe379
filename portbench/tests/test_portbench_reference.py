"""The references on their own: each reproduces the goldens the JAX engine
wrote (``shadow1_tpu_torch/golden/``), so it is right by itself and not
only equal to the port.

* the frozen oracle, compiling ``configs/tor10k.json`` itself at the
  golden's horizon (1.2 s, seed 44): every counter it keeps, the five
  digest words of all 40 windows, and every summary array (its sum and
  its SHA-256);
* the plain PyTorch PHOLD: ``phold_bench`` (65,536 hosts, 20 windows) and
  ``phold_lossy`` (4,096 hosts, 5 % loss): every counter and the SHA-256
  of the per-host hop counts.
"""

from __future__ import annotations

import copy
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "shadow1_tpu_torch" / "golden"


def sha256(a) -> str:
    return hashlib.sha256(np.asarray(a, "<i8").tobytes()).hexdigest()


def test_oracle_reproduces_the_tor10k_golden():
    from portbench.reference import oracle

    gold = json.loads((GOLDEN / "net_tor10k.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/tor10k.json").read_text())
    doc = copy.deepcopy(cfg["experiment"])
    doc["general"]["stop_time"] = "1200 ms"
    assert gold["build"]["tor_experiment"]["seed"] == 44
    out = oracle.expected(doc, [44], gold["windows"])[0]
    assert out["metrics"] == {k: gold["metrics"][k] for k in out["metrics"]}
    assert len(out["metrics"]) >= 20
    words = [[r[f] for f in gold["digest_fields"]] for r in out["ring"]]
    assert words == gold["digests"]
    assert set(out["summary"]) == set(gold["summary"])
    for k, v in out["summary"].items():
        a = np.asarray(v)
        assert int(a.sum()) == int(gold["summary"][k]), k
        if a.ndim:
            assert sha256(a) == gold["sha256"][k], k


@pytest.mark.parametrize("name", ["phold_lossy", "phold_bench"])
def test_phold_reproduces_the_golden(name):
    import torch

    from portbench.reference import phold

    gold = json.loads((GOLDEN / f"{name}.json").read_text())
    c = gold["config"]
    doc = {"engine": {"ev_cap": c["ev_cap"], "outbox_cap": c["outbox_cap"],
                      "max_rounds": c["max_rounds"]},
           "network": {"single_vertex": {"latency": c["latency_ns"],
                                         "loss": c["loss"]}},
           "hosts": [{"name": "lp", "count": c["n_hosts"]}],
           "app": {"model": "phold",
                   "params": {"mean_delay_ns": c["mean_delay_ns"],
                              "init_events": c["init_events"]}}}
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        out = phold.expected(doc, [c["seed"]], c["windows"], "cpu")[0]
    finally:
        torch.set_num_threads(n)
    assert out["metrics"] == {k: gold["metrics"][k] for k in out["metrics"]}
    assert out["summary"]["total_hops"] == gold["total_hops"]
    assert sha256(out["summary"]["hops"]) == gold["hops_sha256"]
    if c["loss"]:
        assert out["metrics"]["pkts_lost"] > 0

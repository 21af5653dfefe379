"""The fleet's per-lane app tables (``fleet/expand.lane_cfg_keys``): an
app names the ``model_cfg`` keys a seed may change (Bitcoin: its
seed-drawn ``tx_origin``), and a seed sweep of it runs as one fleet.

* a 4-lane fleet of a 256-host copy of ``configs/rung5_bitcoin5k.yaml``
  (ring-chord k 8 reaches ±64, so more than 128 hosts keep the chords
  apart), run to window 50, equals lane by lane the solo runs of its
  seeds (metrics, ring rows with the digest words, summaries, every state
  leaf) and the frozen oracle (``portbench/reference/oracle``);
* ``check_uniform`` still refuses every other ``model_cfg`` difference:
  the peer graph, the transactions' times, the payload and INV sizes, and
  ``tx_origin`` of another length or dtype;
* the serve cache keys engines on lane 0's ``model_cfg`` whole, per-lane
  entries included: a batch whose lane 0 draws other origins builds an
  engine of its own, and a hit (same lane 0) rebinds the other lanes'
  origins, each lane then its seed's solo run.
"""

import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from shadow1_tpu_torch.config.experiment import build_experiment
from shadow1_tpu_torch.core.compact import _tree_map
from shadow1_tpu_torch.core.engine import Engine
from shadow1_tpu_torch.fleet.engine import FleetEngine
from shadow1_tpu_torch.fleet.expand import (
    FleetConfigError,
    check_uniform,
    expand_sweep_docs,
    lane_cfg_keys,
)
from shadow1_tpu_torch.telemetry.ring import drain_ring

ROOT = Path(__file__).resolve().parents[1]
BASE_SEED = 2**31 + 5
WINDOWS = 50


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _doc(lanes: int = 0, windows: int = WINDOWS) -> dict:
    doc = yaml.safe_load((ROOT / "configs/rung5_bitcoin5k.yaml").read_text())
    doc["hosts"][0]["count"] = 256
    doc["general"]["stop_time"] = f"{windows * 50} ms"
    doc["engine"].update(metrics_ring=windows, state_digest=1)
    if lanes:
        doc["sweep"] = {"count": lanes, "base_seed": BASE_SEED}
    return doc


def _built(lanes: int, windows: int = WINDOWS, seeds=None):
    doc = _doc(lanes, windows)
    if seeds is not None:
        doc["sweep"] = {"seeds": list(seeds)}
    return [build_experiment(d) for d in expand_sweep_docs(doc)]


@pytest.fixture(scope="module")
def fleet4():
    built = _built(4)
    eng = FleetEngine([b[0] for b in built], built[0][1], device="cpu")
    return built, eng, eng.run(eng.init_state(), WINDOWS)


def test_lane_keys_are_bitcoins_origins(fleet4):
    built, eng, _ = fleet4
    assert lane_cfg_keys(built[0][0]) == ("tx_origin",)
    origins = eng.ctx.model_cfg["tx_origin"]
    assert origins.shape == (4, 200)
    for e, (exp, _, _) in enumerate(built):
        np.testing.assert_array_equal(origins[e], exp.model_cfg["tx_origin"])
    assert len({tuple(o) for o in origins}) == 4


def test_bitcoin_fleet_lanes_equal_solo_runs(fleet4):
    built, eng, st = fleet4
    per = eng.metrics_per_exp(st)
    rows = eng.drain_rings(st)
    for e, (exp, params, _) in enumerate(built):
        solo = Engine(exp, params, device="cpu")
        so = solo.run(solo.init_state(), WINDOWS)
        assert Engine.metrics_dict(so) == per[e], f"lane {e}"
        mine = [{k: v for k, v in r.items() if k != "exp"} for r in rows
                if r["exp"] == e and r["type"] == "ring"]
        assert drain_ring(so, solo.window) == mine, f"lane {e}"
        bad = []
        _tree_map(lambda a, b: bad.append(tuple(a.shape))
                  if not torch.equal(a, b) else None,
                  so, eng.slice_experiment(st, e))
        assert not bad, f"lane {e}: {bad[:4]}"
        want, got = solo.model_summary(so), eng.model_summary(st, e)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert per[0]["events"] > 0 and per[0]["ev_overflow"] == 0
    # Seeds move only the origins of a circulant graph: equal load.
    assert len({m["events"] for m in per}) == 1


def test_bitcoin_fleet_lanes_equal_the_oracle(fleet4):
    from portbench.reference import oracle

    built, eng, st = fleet4
    seeds = [BASE_SEED + e for e in range(4)]
    assert [b[0].seed for b in built] == seeds
    want = oracle.expected(_doc(), seeds, WINDOWS)
    per = eng.metrics_per_exp(st)
    rows = eng.drain_rings(st)
    for e, w in enumerate(want):
        assert {k: per[e][k] for k in w["metrics"]} == w["metrics"]
        mine = {r["window"]: r for r in rows
                if r["exp"] == e and r["type"] == "ring"}
        assert len(w["ring"]) == WINDOWS
        for r in w["ring"]:
            assert {k: mine[r["window"]][k] for k in r} == r, (e, r["window"])
        got = eng.model_summary(st, e)
        for k, v in w["summary"].items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)
    reach = [int(eng.model_summary(st, e)["reach"][:4].sum())
             for e in range(4)]
    assert min(reach) > 0


def _changed(cfg: dict, key: str) -> dict:
    cfg = copy.deepcopy(cfg)
    if key == "peers":
        cfg["peers"] = np.roll(cfg["peers"], 1, axis=0)
    elif key == "tx_time":
        cfg["tx_time"] = cfg["tx_time"] + 1
    elif key == "tx_size":
        cfg["tx_size"] = 300
    elif key == "inv_size":
        cfg["inv_size"] = 40
    elif key == "tx_origin_length":
        cfg["tx_origin"] = cfg["tx_origin"][:-1]
    elif key == "tx_origin_dtype":
        cfg["tx_origin"] = cfg["tx_origin"].astype(np.int32)
    else:
        raise ValueError(key)
    return cfg


@pytest.mark.parametrize("key", ["peers", "tx_time", "tx_size", "inv_size",
                                 "tx_origin_length", "tx_origin_dtype"])
def test_other_model_cfg_differences_are_refused(key):
    (a, params, _), (b, _, _) = _built(2, windows=2)
    assert not np.array_equal(a.model_cfg["tx_origin"],
                              b.model_cfg["tx_origin"])
    check_uniform([a, b], [params] * 2)
    bad = dataclasses.replace(b, model_cfg=_changed(b.model_cfg, key))
    with pytest.raises(FleetConfigError) as ei:
        check_uniform([a, bad], [params] * 2)
    assert (ei.value.kind, ei.value.knob) == ("uniform", "model_cfg")
    assert "outside the fleet-variable set" in str(ei.value)
    with pytest.raises(FleetConfigError):
        FleetEngine([a, bad], params, device="cpu")


def test_serve_cache_keys_lane_zero_and_rebinds_the_others():
    from shadow1_tpu_torch.serve.cache import EngineCache

    windows = 44   # transactions 0-3 are out by window 44 (2 s + 250 ms k)
    s = [BASE_SEED + 10 + i for i in range(3)]
    ab = _built(2, windows, seeds=[s[0], s[1]])
    ac = _built(2, windows, seeds=[s[0], s[2]])
    ba = _built(2, windows, seeds=[s[1], s[0]])
    params = ab[0][1]
    cache = EngineCache(capacity=4)
    eng, how = cache.get([b[0] for b in ab], params, device="cpu")
    assert how == "miss"
    again, how = cache.get([b[0] for b in ac], params, device="cpu")
    assert (again, how) == (eng, "hit")
    np.testing.assert_array_equal(eng.ctx.model_cfg["tx_origin"][1],
                                  ac[1][0].model_cfg["tx_origin"])
    st = eng.run(eng.init_state(), windows)
    for e, (exp, p, _) in enumerate(ac):
        solo = Engine(exp, p, device="cpu")
        so = solo.run(solo.init_state(), windows)
        assert Engine.metrics_dict(so) == eng.metrics_per_exp(st)[e]
        np.testing.assert_array_equal(
            eng.model_summary(st, e)["seen_time"],
            solo.model_summary(so)["seen_time"])
    other, how = cache.get([b[0] for b in ba], params, device="cpu")
    assert how == "miss" and other is not eng and len(cache) == 2
    with pytest.raises(FleetConfigError) as ei:
        eng.rebind([b[0] for b in ba])
    assert (ei.value.kind, ei.value.knob) == ("shape", "model_cfg")

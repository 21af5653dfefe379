"""The port's fleet against the JAX package, on the CPU.

The contract (docs/SEMANTICS.md "Fleet contract"): lane e of a fleet is
bit-identical to a solo run of experiment e — every Metrics field, every
ring row (the per-window digest words included), every summary array and
every state leaf. The port folds the lanes onto the host axis
(``shadow1_tpu_torch/fleet/engine.py``); ``convert.fleet_to_saved`` puts a
port fleet state in the reference's ``[E, ...]`` layout, so the whole state
is held leaf by leaf to the JAX ``FleetEngine``'s. The sweep expansion is
held to the reference's, its rejections included. Tolerance: zero
(everything compared is an integer).

The JAX side runs as its own tests run it: the ``FleetEngine`` and the
solo ``Engine`` on the CPU. Net fleets whose JAX program takes long to
compile are held to the JAX ``FleetEngine`` in ``slow`` tests; in tier-1
each of their lanes is held to the port's solo ``Engine`` (itself held to
the JAX engine on the same experiments by ``test_torch_{tgen,dgram,tor,
bitcoin}.py``).
"""

import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from shadow1_tpu.consts import EngineParams as EngineParamsJ
from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.fleet import expand as expand_j
from shadow1_tpu.fleet.engine import FleetEngine as FleetEngineJ
from shadow1_tpu.telemetry.ring import drain_ring as drain_j
from shadow1_tpu_torch import convert
from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config.compiled import experiment_arrays
from shadow1_tpu_torch.consts import MS, SEC
from shadow1_tpu_torch.consts import EngineParams as EngineParamsT
from shadow1_tpu_torch.core.compact import _tree_map
from shadow1_tpu_torch.core.engine import Engine as EngineT
from shadow1_tpu_torch.fault.schedule import FaultSchedule
from shadow1_tpu_torch.fleet import expand as expand_t
from shadow1_tpu_torch.fleet.engine import FleetEngine as FleetEngineT
from shadow1_tpu_torch.telemetry.ring import drain_ring as drain_t
from tests.test_torch_fidelity import jax_experiment
from tests.test_torch_tgen import (  # noqa: F401  (fixture)
    _one_thread,
    assert_same_leaves,
    port_experiment,
)

ROOT = Path(__file__).resolve().parents[1]
SWEEP = str(ROOT / "configs" / "sweep_phold.yaml")
WINDOWS = 12


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "exp"} for r in recs]


def run_port_fleet(exps, params: dict, windows: int, max_rounds=None):
    eng = FleetEngineT(exps, EngineParamsT(**params), max_rounds,
                       device="cpu")
    return eng, eng.run(n_windows=windows)


def run_jax_fleet(exps, params: dict, windows: int, max_rounds=None):
    eng = FleetEngineJ(exps, EngineParamsJ(**params), max_rounds)
    return eng, eng.run(n_windows=windows)


def assert_fleet_matches_jax_fleet(eng_j, st_j, eng_t, st_t):
    """Whole state leaf by leaf (reference layout), per-lane metrics, ring
    records and model summaries."""
    assert_same_leaves(jax.tree.map(np.asarray, st_j),
                       convert.state_to_numpy(
                           convert.fleet_to_saved(st_t, eng_t.n_exp)))
    assert eng_t.metrics_per_exp(st_t) == FleetEngineJ.metrics_per_exp(st_j)
    assert eng_t.metrics_dict(st_t) == FleetEngineJ.metrics_dict(st_j)
    assert eng_t.drain_rings(st_t) == eng_j.drain_rings(st_j)
    for e in range(eng_t.n_exp):
        sj, stt = eng_j.model_summary(st_j, e), eng_t.model_summary(st_t, e)
        assert set(sj) == set(stt)
        for k in sj:
            np.testing.assert_array_equal(stt[k], np.asarray(sj[k]), err_msg=k)


def assert_lanes_match_port_solo(eng_t, st_t, exps, params: dict, windows,
                                 max_rounds=None):
    """Every lane equals the port's solo run of its experiment: metrics,
    ring rows, summaries and every state leaf (``slice_experiment``)."""
    rings = eng_t.drain_rings(st_t)
    per = eng_t.metrics_per_exp(st_t)
    for e, exp in enumerate(exps):
        p = dict(params)
        if max_rounds is not None:
            p["max_rounds"] = max_rounds[e]
        solo = EngineT(exp, EngineParamsT(**p), device="cpu")
        st = solo.run(n_windows=windows)
        assert EngineT.metrics_dict(st) == per[e], f"lane {e}"
        assert drain_t(st, solo.window) == _strip(
            r for r in rings if r["exp"] == e
            and r["type"].startswith("ring")), f"lane {e}"
        lane = eng_t.slice_experiment(st_t, e)
        bad = []
        _tree_map(lambda a, b: bad.append((tuple(a.shape), tuple(b.shape)))
                  if not torch.equal(a, b) else None, st, lane)
        assert not bad, f"lane {e}: {bad[:4]}"
        want, got = solo.model_summary(st), eng_t.model_summary(st_t, e)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# sweep expansion
# ---------------------------------------------------------------------------

def test_load_sweep_matches_jax():
    pj, pt = expand_j.load_sweep(SWEEP), expand_t.load_sweep(SWEEP)
    assert pt.n_exp == pj.n_exp == 4
    assert pt.labels == pj.labels and pt.max_rounds == pj.max_rounds
    assert pt.scheduler == pj.scheduler
    assert dataclasses.asdict(pt.params) == dataclasses.asdict(pj.params)
    for ej, et in zip(pj.exps, pt.exps):
        aj, at = experiment_arrays(ej), experiment_arrays(et)
        assert set(aj) == set(at)
        for k in aj:
            np.testing.assert_array_equal(at[k], aj[k], err_msg=k)


def _base_doc(count=16):
    return {
        "general": {"seed": 7, "stop_time": "150 ms"},
        "engine": {"scheduler": "tpu", "ev_cap": 32, "outbox_cap": 16},
        "network": {"single_vertex": {"latency": "10 ms"}},
        "hosts": [{"name": "h", "count": count}],
        "app": {"model": "phold",
                "params": {"mean_delay_ns": 2.0e7, "init_events": 2}},
    }


# The reference's rejection cases (tests/test_fleet.py): (sweep section,
# expand_sweep or only the docs, kind, knob, message fragment).
REJECTIONS = {
    "unknown_key": ({"seedz": [1, 2]}, False, "schema", None, "unknown"),
    "length_mismatch": ({"seeds": [1, 2], "vary": [{}, {}, {}]}, False,
                        "schema", None, "disagree"),
    "empty": ({}, False, "schema", None, "at least one"),
    "seeds_not_list": ({"seeds": 5}, False, "schema", None, "must be a list"),
    "count_not_int": ({"count": "sixteen"}, False, "schema", None,
                      "must be an integer"),
    "seed_not_int": ({"seeds": ["a", "b"]}, False, "schema", None,
                     "seeds[0]"),
    "vary_not_list": ({"vary": {"not": "a list"}}, False, "schema", None,
                      "must be a list"),
    "vary_not_mapping": ({"vary": [None, 42]}, False, "schema", None,
                         "must be a mapping"),
    "hosts": ({"vary": [{}, {"hosts": [{"name": "h", "count": 8}]}]}, True,
              "shape", "n_hosts", "plane shapes"),
    "ev_cap": ({"vary": [{}, {"engine": {"ev_cap": 64}}]}, True, "shape",
               "engine.ev_cap", "fleet-uniform"),
    "latency": ({"vary": [{}, {"network": {"single_vertex": {
        "latency": "5 ms"}}}]}, True, "shape", "lat_vv",
        "conservative window"),
    "stop_time": ({"vary": [{}, {"general": {"stop_time": "1 s"}}]}, True,
                  "shape", "end_time", "plane shapes"),
    "model_cfg": ({"vary": [{}, {"app": {"model": "phold", "params": {
        "mean_delay_ns": 1.0e7, "init_events": 2}}}]}, True, "uniform",
        "model_cfg", "fleet-variable"),
}


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_sweep_rejections_match_jax(name):
    """Each of the reference's rejections raises FleetConfigError with the
    same kind, knob and message in both packages."""
    sweep, full, kind, knob, frag = REJECTIONS[name]
    errs = []
    for mod in (expand_j, expand_t):
        doc = _base_doc()
        doc["sweep"] = copy.deepcopy(sweep)
        with pytest.raises(mod.FleetConfigError) as ei:
            (mod.expand_sweep if full else mod.expand_sweep_docs)(doc)
        errs.append(ei.value)
    assert [(e.kind, e.knob, str(e)) for e in errs][0] == \
        (errs[1].kind, errs[1].knob, str(errs[1]))
    assert errs[1].kind == kind and errs[1].knob == knob
    assert frag in str(errs[1])


def test_sweep_count_and_max_rounds_expand_like_jax():
    doc = _base_doc()
    doc["sweep"] = {"count": 3, "base_seed": 20,
                    "vary": [{}, {"engine": {"max_rounds": 128}}, None]}
    pj, pt = expand_j.expand_sweep(doc), expand_t.expand_sweep(doc)
    assert [e.seed for e in pt.exps] == [e.seed for e in pj.exps] == [20, 21, 22]
    assert pt.max_rounds == pj.max_rounds == [256, 128, 256]
    assert expand_t.expand_sweep_docs(doc) == expand_j.expand_sweep_docs(doc)


# ---------------------------------------------------------------------------
# PHOLD: the sweep, against the JAX FleetEngine and the JAX solo Engine
# ---------------------------------------------------------------------------

PHOLD_PARAMS = dict(ev_cap=64, outbox_cap=32, metrics_ring=WINDOWS,
                    state_digest=1)
MAX_ROUNDS = {"uniform": None, "non_uniform": [256, 3, 256, 2]}


@pytest.mark.parametrize("case", list(MAX_ROUNDS))
def test_phold_sweep_matches_jax(case):
    """``configs/sweep_phold.yaml``'s lanes (seeds, a loss ladder, a churn
    lane), and the same sweep with per-lane ``max_rounds`` low enough that
    two lanes hit their cap while the others run on."""
    mr = MAX_ROUNDS[case]
    pj, pt = expand_j.load_sweep(SWEEP), expand_t.load_sweep(SWEEP)
    eng_j, st_j = run_jax_fleet(pj.exps, PHOLD_PARAMS, WINDOWS, mr)
    eng_t, st_t = run_port_fleet(pt.exps, PHOLD_PARAMS, WINDOWS, mr)
    assert_fleet_matches_jax_fleet(eng_j, st_j, eng_t, st_t)
    per = eng_t.metrics_per_exp(st_t)
    rings = eng_t.drain_rings(st_t)
    for e, exp in enumerate(pj.exps):
        p = dict(PHOLD_PARAMS, max_rounds=(mr or [256] * 4)[e])
        solo = EngineJ(exp, EngineParamsJ(**p))
        st = solo.run(n_windows=WINDOWS)
        assert EngineJ.metrics_dict(st) == per[e], f"lane {e}"
        assert drain_j(st, solo.window) == _strip(
            r for r in rings if r["exp"] == e), f"lane {e}"
    if mr is not None:
        assert [m["round_cap_hits"] > 0 for m in per] == \
            [False, True, False, True]
    assert per[3]["down_events"] + per[3]["down_pkts"] > 0
    assert per[2]["pkts_lost"] > per[1]["pkts_lost"] > 0


def test_one_lane_fleet_equals_port_solo():
    """E = 1: a one-lane fleet equals the port's solo run (and keeps its
    lane axis: metrics [1], ring [1, W, F])."""
    exp = expand_t.load_sweep(SWEEP).exps[3]
    eng, st = run_port_fleet([exp], PHOLD_PARAMS, WINDOWS)
    assert st.metrics.events.shape == (1,)
    assert st.telem.buf.shape[0] == 1
    assert_lanes_match_port_solo(eng, st, [exp], PHOLD_PARAMS, WINDOWS)


# ---------------------------------------------------------------------------
# the net model
# ---------------------------------------------------------------------------

def fx(seed, loss, n=4, **kw):
    """The reference's 3-lane filexfer fleet's experiment
    (tests/test_fleet.py::test_fleet_net_model_parity)."""
    role = np.full(n, 1, np.int64)
    role[0] = 0
    return ct.single_vertex_experiment(
        n_hosts=n, seed=seed, end_time=2_000 * MS, latency_ns=10 * MS,
        loss=loss, bw_bits=10**7, model="net", model_cfg={
            "app": "filexfer", "role": role,
            "server": np.zeros(n, np.int64),
            "flow_bytes": np.full(n, 30_000, np.int64),
            "start_time": np.full(n, 1 * MS, np.int64),
            "flow_count": np.where(role == 1, 1, 0)}, **kw)


def _faults_lanes():
    """Three lanes of which two carry different fault schedules (host
    churn; a loss ramp and a link outage) and one none: the fleet pads
    the tables with inert entries."""
    a, b, c = fx(11, 0.0, n=6), fx(11, 0.02, n=6), fx(12, 0.0, n=6)
    b.faults = FaultSchedule(host_id=[1, 2], host_down=[50 * MS, 80 * MS],
                             host_up=[120 * MS, 10**18])
    c.faults = FaultSchedule(
        ramp_src=[0], ramp_dst=[0], ramp_t0=[20 * MS], ramp_t1=[200 * MS],
        ramp_loss=[0.3], link_src=[0], link_dst=[0], link_t0=[100 * MS],
        link_t1=[150 * MS])
    return [a, b, c]


def _cpu_lanes():
    """The virtual CPU (``push_back`` every round) under two seeds."""
    cpu = dict(cpu_ns_per_event=np.full(4, 3 * MS, np.int64))
    return [fx(11, 0.0, **cpu), fx(13, 0.05, **cpu)]


def _tgen_lanes():
    from tests.test_tgen_parity import tgen_exp

    return [port_experiment(tgen_exp(n_hosts=6, seed=s, loss=lo, end=SEC))
            for s, lo in ((4, 0.0), (5, 0.02))]


def _dgram_lanes():
    from tests.test_torch_dgram import _mesh

    m = _mesh()
    return [port_experiment(m), port_experiment(dataclasses.replace(
        m, seed=99, loss_vv=np.full((1, 1), 0.1, np.float32)))]


def _tor_lanes():
    from tests.test_tor_parity import tor_exp

    return [port_experiment(tor_exp(seed=s, loss=lo, end=SEC, n_circuits=1,
                                    n_streams=1, mean_cells=10.0))
            for s, lo in ((31, 0.0), (32, 0.02))]


def _bitcoin_lanes():
    from tests.test_bitcoin_parity import btc_exp

    b = btc_exp()
    return [port_experiment(b), port_experiment(dataclasses.replace(
        b, seed=5, loss_vv=np.full((1, 1), 0.02, np.float32)))]


NET_PARAMS = dict(ev_cap=64, outbox_cap=16, state_digest=1)
APP_PARAMS = dict(ev_cap=256, state_digest=1)
# name -> (lanes, engine params, windows)
NET = {
    "filexfer": (lambda: [fx(11, 0.0), fx(11, 0.02), fx(12, 0.05)],
                 NET_PARAMS, 40),
    "faults": (_faults_lanes, NET_PARAMS, 40),
    "cpu": (_cpu_lanes, NET_PARAMS, 40),
    "tgen": (_tgen_lanes, APP_PARAMS, 40),
    "dgram": (_dgram_lanes, APP_PARAMS, 30),
    "tor": (_tor_lanes, APP_PARAMS, 30),
    "bitcoin": (_bitcoin_lanes, APP_PARAMS, 60),
}


# The fault lanes with two flow probes, a host view and the link
# accumulator on: the per-lane probe ring and accumulator.
PLANES = dict(probes=((0, 0), (1, 0), (2, -1)), link_telem=1)


def _net_case(name):
    if name == "planes":
        make, params, windows = _net_case("faults")
        return make, dict(params, **PLANES), windows
    make, params, windows = NET[name]
    return make, dict(params, metrics_ring=windows), windows


@pytest.mark.parametrize("name", list(NET))
def test_net_fleet_lanes_match_port_solo(name):
    make, params, windows = _net_case(name)
    exps = make()
    eng, st = run_port_fleet(exps, params, windows)
    assert_lanes_match_port_solo(eng, st, exps, params, windows)
    per = eng.metrics_per_exp(st)
    assert all(m["events"] > 0 for m in per)
    if name == "faults":
        assert per[0]["down_events"] + per[0]["link_down_pkts"] == 0
        assert per[1]["host_restarts"] > 0
        assert per[2]["link_down_pkts"] > 0
    if name == "cpu":
        assert per[0]["fires_app"] > 0


def test_probe_and_link_planes_per_lane():
    """With flow probes and the link accumulator on, every lane's flow and
    link records (and its probe ring and accumulator leaves) equal its
    solo run's: the fault lanes, so losses, link-down drops and restarts
    reach the edges."""
    from shadow1_tpu_torch.telemetry.links import drain_links
    from shadow1_tpu_torch.telemetry.probes import drain_probes

    make, params, windows = _net_case("planes")
    exps = make()
    eng, st = run_port_fleet(exps, params, windows)
    assert st.probes.buf.shape[:2] == (3, windows)
    assert st.links.buf.shape[0] == 3
    assert_lanes_match_port_solo(eng, st, exps, params, windows)
    recs = eng.drain_rings(st)
    for e, exp in enumerate(exps):
        solo = EngineT(exp, EngineParamsT(**params), device="cpu")
        ss = solo.run(n_windows=windows)
        want = (drain_probes(ss, solo.window, solo.params.probes)
                + drain_links(ss, solo.window))
        got = _strip(r for r in recs if r["exp"] == e
                     and r["type"] in ("flow", "link"))
        assert got == want, f"lane {e}"
        assert any(r["type"] == "link" for r in got)
    link = [r for r in recs if r["type"] == "link"]
    assert sum(r["link_down_drops"] for r in link if r["exp"] == 2) > 0
    assert sum(r["link_down_drops"] for r in link if r["exp"] != 2) == 0


def test_filexfer_fleet_matches_jax_fleet():
    """The reference's 3-lane filexfer fleet (a loss ladder, two seeds):
    the whole state leaf by leaf against the JAX FleetEngine."""
    make, params, windows = _net_case("filexfer")
    eng_j, st_j = run_jax_fleet([jax_experiment(e) for e in make()], params,
                                windows)
    eng_t, st_t = run_port_fleet(make(), params, windows)
    assert_fleet_matches_jax_fleet(eng_j, st_j, eng_t, st_t)


@pytest.mark.slow
@pytest.mark.parametrize("name",
                         [n for n in NET if n != "filexfer"] + ["planes"])
def test_net_fleet_matches_jax_fleet(name):
    """The other net fleets, and the fault lanes with the probe and link
    planes on, against the JAX FleetEngine (a JAX compile of 25-65 s each
    on the CPU)."""
    make, params, windows = _net_case(name)
    eng_j, st_j = run_jax_fleet([jax_experiment(e) for e in make()], params,
                                windows)
    eng_t, st_t = run_port_fleet(make(), params, windows)
    assert_fleet_matches_jax_fleet(eng_j, st_j, eng_t, st_t)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _json_lines(text):
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def test_cli_fleet_records_match_jax(tmp_path):
    """``--fleet`` prints the JAX CLI's fleet_exp records and exp-tagged
    ring records; the fleet_summary agrees on everything but the clock."""
    args = [SWEEP, "--fleet", "--windows", "6", "--metrics-ring", "6"]
    env = dict(__import__("os").environ, JAX_PLATFORMS="cpu")
    rj = subprocess.run([sys.executable, "-m", "shadow1_tpu", *args],
                        capture_output=True, text=True, cwd=ROOT, env=env,
                        timeout=600)
    rt = subprocess.run([sys.executable, "-m", "shadow1_tpu_torch", *args,
                         "--device", "cpu"], capture_output=True, text=True,
                        cwd=ROOT, env=env, timeout=600)
    assert rj.returncode == 0, rj.stderr[-2000:]
    assert rt.returncode == 0, rt.stderr[-2000:]
    jr = _json_lines(rj.stdout) + _json_lines(rj.stderr)
    tr = _json_lines(rt.stdout)

    def of(recs, kind):
        return [r for r in recs if r.get("type") == kind]

    assert of(tr, "fleet_exp") == of(jr, "fleet_exp")
    assert len(of(tr, "fleet_exp")) == 4
    assert of(tr, "ring") == of(jr, "ring") and len(of(tr, "ring")) == 24
    clock = ("wall_seconds", "sim_per_wall", "events_per_sec")
    sj, st = of(jr, "fleet_summary")[0], of(tr, "fleet_summary")[0]
    assert {k: v for k, v in st.items() if k not in clock} == \
        {k: v for k, v in sj.items() if k not in clock}


def test_cli_fleet_rejections(tmp_path):
    """A rejected sweep is one fleet_config record with EXIT_CONFIG, as in
    the reference; a solo config under --fleet names the missing section."""
    from shadow1_tpu_torch.consts import EXIT_CONFIG

    bad = tmp_path / "bad.yaml"
    doc = _base_doc()
    doc["sweep"] = {"vary": [{}, {"engine": {"ev_cap": 64}}]}
    import yaml

    bad.write_text(yaml.safe_dump(doc))
    for cfg, knob in ((str(bad), "engine.ev_cap"),
                      (str(ROOT / "configs" / "churn_filexfer.yaml"), None)):
        r = subprocess.run([sys.executable, "-m", "shadow1_tpu_torch", cfg,
                            "--fleet", "--device", "cpu"],
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=300)
        assert r.returncode == EXIT_CONFIG
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        assert rec["error"] == "fleet_config" and rec["knob"] == knob


# ---------------------------------------------------------------------------
# the card's fleet golden
# ---------------------------------------------------------------------------

def test_sweep_phold_builder_is_the_yaml_sweep():
    """``sweep_phold_experiments`` (built in code for the card) holds the
    YAML sweep's lanes: its lane 5·e is the YAML's lane e."""
    exps, params, max_rounds, labels = ct.sweep_phold_experiments()
    plan = expand_t.load_sweep(SWEEP)
    assert len(exps) == 17 and max_rounds[-1] < max_rounds[0]
    assert dataclasses.asdict(params) == dataclasses.asdict(plan.params)
    for e, exp in enumerate(plan.exps):
        assert labels[5 * e]["seed"] == exp.seed
        a, b = experiment_arrays(exp), experiment_arrays(exps[5 * e])
        # YAML reads ``2.0e7`` as a string, which PHOLD reads with float().
        cfg_a, cfg_b = a.pop("model_cfg"), b.pop("model_cfg")
        assert {k: float(v) for k, v in cfg_a.items()} == \
            {k: float(v) for k, v in cfg_b.items()}
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_port_fleet_equals_the_card_golden():
    """The port's fleet on the CPU equals ``golden/fleet_sweep_phold.json``
    (the JAX FleetEngine's), lane by lane: what ``chip_smoke.py`` phase 15
    holds the card to."""
    import hashlib

    gold = json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / "fleet_sweep_phold.json").read_text())
    exps, params, max_rounds, labels = ct.sweep_phold_experiments()
    w = gold["windows"]
    eng = FleetEngineT(exps, dataclasses.replace(
        params, metrics_ring=w, state_digest=1), max_rounds, device="cpu")
    st = eng.run(n_windows=w)
    per, rings = eng.metrics_per_exp(st), eng.drain_rings(st)
    assert [l["label"] for l in gold["lanes"]] == labels
    for e, lane in enumerate(gold["lanes"]):
        assert per[e] == lane["metrics"], f"lane {e}"
        rows = [[r[f] for f in gold["digest_fields"]] for r in rings
                if r["exp"] == e]
        assert rows == lane["digests"], f"lane {e}"
        summ = eng.model_summary(st, e)
        for k, want in lane["sha256"].items():
            got = hashlib.sha256(np.asarray(summ[k], "<i8").tobytes())
            assert got.hexdigest() == want, (e, k)
    assert per[-1]["round_cap_hits"] > 0


def test_rebind_swaps_the_variable_knobs():
    """``FleetEngine.rebind`` (what serve will build on): a new set of the
    same shape class runs equal to a fresh engine of it; a set that would
    change the program's structure is refused as the reference refuses."""
    plan = expand_t.load_sweep(SWEEP)
    params = EngineParamsT(**PHOLD_PARAMS)
    eng = FleetEngineT(plan.exps, params, device="cpu")
    sig = eng.variant_signature()
    new = [dataclasses.replace(e, seed=e.seed + 10) for e in plan.exps]
    eng.rebind(new)
    assert eng.variant_signature() == sig
    fresh = FleetEngineT(new, params, device="cpu")
    a, b = eng.run(n_windows=4), fresh.run(n_windows=4)
    assert eng.metrics_per_exp(a) == fresh.metrics_per_exp(b)
    with pytest.raises(expand_t.FleetConfigError) as ei:
        eng.rebind(new[:3])
    assert (ei.value.kind, ei.value.knob) == ("mode", "n_exp")
    calm = [dataclasses.replace(e, faults=None) for e in new]
    with pytest.raises(expand_t.FleetConfigError) as ei:
        eng.rebind(calm)
    assert ei.value.knob == "variants"
    assert eng.exps == new            # a refused rebind keeps the old set

"""The tracer inside the port's round loop (``telemetry/profiler.py``), on
the CPU.

* clock: a PhaseProfiler span holds the ``torch.profiler`` record of the
  same scope on the profiler's own clock, in raw ns and in the two Chrome
  traces' µs;
* read coverage: one pass with the tracer active, counted by
  ``tools/opcensus.count_call`` at the same time, reads as many times as
  the census counts, and every read site the pass reaches is in the
  tracer (a 2-lane Tor fleet of 22 hosts a lane in window 8 of its
  bootstrap; PHOLD at 256 LPs, compacted, windows 4-6; a 2-lane Bitcoin
  fleet of 160 hosts a lane in windows 44-45 of its flood);
* span counts: one ``round:pop`` per iteration of the round loop (the
  solo ``Metrics.rounds`` delta; the fleet's rounds as
  ``portbench/harness.pass_rounds`` counts them), every ``round:*`` span
  inside a ``phase:rounds`` span and every ``read:*`` inside a round or
  phase span;
* off is off: with no tracer a ``torch.profiler`` capture holds no
  ``round:`` or ``read:`` name, and the counters and ring rows of the
  pass are those of the traced pass;
* the Bitcoin app's spans: one ``round:btc:wakeup`` inside each
  ``round:h:app`` pass, one ``round:btc:notify`` inside each
  ``round:h:deliver`` pass, every ``round:btc:push`` inside one of them,
  and each push span holding exactly one push launch (``popk.LAUNCHES``;
  on the CPU the plain push counts itself as the card's kernel would).
"""

import contextlib

import copy
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import clone_tree, pass_rounds
from shadow1_tpu_torch.config.experiment import build_experiment
from shadow1_tpu_torch.telemetry import profiler as P
from shadow1_tpu_torch.tools.opcensus import count_call

ROOT = Path(__file__).resolve().parents[1]
TOR_HOSTS = {"guard": 3, "middle": 4, "exit": 2, "dirauth": 1, "client": 12}
# name -> (start window, span, sites the pass must reach)
CASES = {
    "tor": (8, 1, {"lanes", "dispatch", "tcp_listen", "tcp_send",
                   "tcp_burst", "tcp_fin", "tor_notify", "tor_dir",
                   "tor_guard", "tor_build", "tor_wakeup"}),
    "phold": (4, 3, {"continue", "compact"}),
    "bitcoin": (44, 2, {"btc_wakeup", "btc_accept", "dispatch", "lanes",
                        "tcp_send"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(name):
    if name in ("tor", "bitcoin"):
        from shadow1_tpu_torch.fleet.engine import FleetEngine
        from shadow1_tpu_torch.fleet.expand import expand_sweep_docs

        doc = json.loads((ROOT / f"portbench/configs/"
                          f"{'tor10k' if name == 'tor' else 'bitcoin5k'}"
                          f".json").read_text())["experiment"]
        for g in doc["hosts"]:
            g["count"] = TOR_HOSTS.get(g["name"], 160)
        doc["sweep"] = {"count": 2, "base_seed": 2**31 + 5}
        built = [build_experiment(d) for d in expand_sweep_docs(doc)]
        return FleetEngine([b[0] for b in built], built[0][1], device="cpu")
    from shadow1_tpu_torch.core.engine import Engine

    doc = copy.deepcopy(json.loads((ROOT / "portbench/configs/phold.json")
                                   .read_text())["experiment"])
    doc["hosts"][0]["count"] = 256
    doc["engine"]["compact_cap"] = 128
    exp, params, _ = build_experiment(doc)
    return Engine(exp, params, device="cpu")


def _rows(eng, st):
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    if eng.ctx.n_exp:
        return eng.drain_rings(st)
    return drain_ring(st, eng.window)


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """One case's pass twice from the same start state: untraced under a
    CPU ``torch.profiler`` capture, and traced under the census."""
    name = request.param
    start, span, sites = CASES[name]
    eng = _engine(name)
    st0 = eng.run(eng.init_state(), start)
    with profile(activities=[ProfilerActivity.CPU]) as cap:
        off = eng.run(clone_tree(st0), span)
    tracer = P.PhaseProfiler(round_events=True)
    with P.active(tracer):
        on, census = count_call(eng.run, clone_tree(st0), span)
    return {"name": name, "eng": eng, "st0": st0, "off": off, "on": on,
            "census": census, "tracer": tracer, "sites": sites,
            "start": start, "span": span,
            "off_names": {e.name() for e in
                          cap.profiler.kineto_results.events()}}


def test_span_holds_profiler_record_on_shared_clock(tmp_path):
    x = torch.ones(64, 64)
    prof = P.PhaseProfiler()
    with profile(activities=[ProfilerActivity.CPU]) as cap:
        for _ in range(3):
            with prof.span("clock-probe"):
                x = x @ x / 64
    mine = [e for e in prof.chrome_trace()["traceEvents"]
            if e["name"] == "clock-probe"]
    theirs = [e for e in cap.profiler.kineto_results.events()
              if e.name() == "clock-probe"]
    assert len(mine) == len(theirs) == 3
    slack_ns = 50_000
    for m, t in zip(mine, theirs):
        m0 = round(m["ts"] * 1e3) + prof.base_ns
        m1 = m0 + round(m["dur"] * 1e3)
        assert m0 - slack_ns <= t.start_ns() <= t.end_ns() <= m1 + slack_ns
    path = tmp_path / "trace.json"
    cap.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert trace["baseTimeNanoseconds"] == prof.chrome_trace()[
        "baseTimeNanoseconds"]
    theirs = [e for e in trace["traceEvents"] if e.get("name") == "clock-probe"]
    for m, t in zip(mine, theirs):
        assert m["ts"] - 50 <= t["ts"] <= t["ts"] + t["dur"] <= (
            m["ts"] + m["dur"] + 50)


def test_reads_match_census(run):
    reads = run["tracer"].reads()
    assert sum(c for c, _ in reads.values()) == run["census"].reads > 0
    assert run["sites"] <= set(reads), set(reads)
    for site, (c, ns) in reads.items():
        assert c > 0 and ns >= 0, site
        assert run["tracer"].total(P.READ_PREFIX + site) == (c, ns)


def test_round_spans_count_loop_iterations(run):
    tracer, eng = run["tracer"], run["eng"]
    pops = tracer.total(P.RS_POP)[0]
    if eng.ctx.n_exp:
        e = eng.ctx.n_exp
        rows = [r for r in _rows(eng, run["on"]) if r["type"] == "ring"]
        outs = [{"ring": [r for r in rows if r["exp"] == i]} for i in range(e)]
        want = pass_rounds(outs, run["start"], run["start"] + run["span"])
    else:
        want = int(run["on"].metrics.rounds - run["st0"].metrics.rounds)
    assert pops == want > 0
    evs = [e for e in tracer.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert sum(e["name"] == P.RS_POP for e in evs) == pops

    def within(inner, outers):
        return any(o["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
                   <= o["ts"] + o["dur"] for o in outers)

    rounds = [e for e in evs if e["name"] == P.PH_ROUNDS]
    assert len(rounds) == run["span"]
    inner = [e for e in evs if e["name"].startswith(P.ROUND_PREFIX)]
    assert all(within(e, rounds) for e in inner)
    outer = [e for e in evs if e["name"].startswith(("phase:", "round:"))]
    assert all(within(e, outer) for e in evs
               if e["name"].startswith(P.READ_PREFIX))


def test_off_is_off(run):
    assert not {n for n in run["off_names"]
                if n.startswith((P.ROUND_PREFIX, P.READ_PREFIX))}
    assert P.PH_ROUNDS in run["off_names"]
    eng = run["eng"]
    assert eng.metrics_dict(run["off"]) == eng.metrics_dict(run["on"])
    for a, b in zip(run["off"].metrics, run["on"].metrics):
        assert torch.equal(a, b)
    assert _rows(eng, run["off"]) == _rows(eng, run["on"])


def test_no_tracer_costs_a_shared_null_context():
    assert P._ACTIVE is None
    assert P.round_span("round:pop") is P.round_span("round:dispatch")
    assert P.read("x", bool, torch.ones(())) is True
    prof = P.PhaseProfiler()
    with P.active(prof):
        assert P._ACTIVE is prof
        with P.round_span("round:pop"):
            P.read("x", int, torch.ones((), dtype=torch.int64))
    assert P._ACTIVE is None
    assert prof.reads() == {"x": (1, prof.total("read:x")[1])}
    assert prof.total("round:pop")[0] == 1
    assert prof.span_names() == []


def test_cli_trace_keeps_round_totals_as_chunk_counters(tmp_path, capsys):
    from shadow1_tpu_torch import cli

    path = tmp_path / "t.json"
    assert cli.main([str(ROOT / "configs/rung1_filexfer.yaml"), "--device",
                     "cpu", "--windows", "6", "--heartbeat", "3",
                     "--trace", str(path)]) == 0
    capsys.readouterr()
    evs = json.loads(path.read_text())["traceEvents"]
    xs = [e["name"] for e in evs if e["ph"] == "X"]
    assert xs.count("run-chunk") == 2
    assert not [n for n in xs if n.startswith(("round:", "read:", "phase:"))]
    counters = [e for e in evs if e["ph"] == "C"]
    pops = [e["args"]["n"] for e in counters if e["name"] == P.RS_POP]
    assert len(pops) == 2 and 0 < pops[0] <= pops[1]
    assert {"read:continue", "round:continue", P.PH_ROUNDS} <= {
        e["name"] for e in counters}


@pytest.fixture(scope="module")
def btc():
    """A traced pass of the Bitcoin case, the push launches counted inside
    each ``round:btc:push`` span."""
    from shadow1_tpu_torch.apps import bitcoin
    from shadow1_tpu_torch.core import popk

    start, span, _ = CASES["bitcoin"]
    eng = _engine("bitcoin")
    st0 = eng.run(eng.init_state(), start)
    real_push, real_span = popk.push_local, bitcoin.round_span
    deltas = []

    def push(buf, *a, **k):
        out = real_push(buf, *a, **k)
        if not buf.kind.is_cuda:
            popk.LAUNCHES["push"] += 1
        return out

    @contextlib.contextmanager
    def counted(name):
        n0 = popk.LAUNCHES["push"]
        with real_span(name):
            yield
        if name == P.RS_BTC_PUSH:
            deltas.append(popk.LAUNCHES["push"] - n0)

    tracer = P.PhaseProfiler(round_events=True)
    popk.push_local, bitcoin.round_span = push, counted
    try:
        with P.active(tracer):
            eng.run(clone_tree(st0), span)
    finally:
        popk.push_local, bitcoin.round_span = real_push, real_span
    evs = [e for e in tracer.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    return {"tracer": tracer, "deltas": deltas, "evs": evs}


def _inside(inner, outers) -> bool:
    return any(o["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
               <= o["ts"] + o["dur"] for o in outers)


def test_bitcoin_spans_nest_in_their_handler_passes(btc):
    by = {}
    for e in btc["evs"]:
        by.setdefault(e["name"], []).append(e)
    app, deliver = by[P.ROUND_HANDLER + "app"], by[P.ROUND_HANDLER + "deliver"]
    wake, notify = by[P.RS_BTC_WAKEUP], by[P.RS_BTC_NOTIFY]
    assert len(wake) == len(app) > 0 and len(notify) == len(deliver) > 0
    assert all(_inside(e, app) for e in wake)
    assert all(_inside(e, deliver) for e in notify)
    assert all(_inside(e, wake + notify) for e in by[P.RS_BTC_PUSH])


def test_bitcoin_push_spans_count_push_launches(btc):
    pushes = btc["tracer"].total(P.RS_BTC_PUSH)[0]
    assert len(btc["deltas"]) == pushes > 0
    assert set(btc["deltas"]) == {1}
    # A delivered message makes a reply push and K = 8 announcements.
    assert pushes >= 9 * btc["tracer"].total(P.RS_BTC_NOTIFY)[0]

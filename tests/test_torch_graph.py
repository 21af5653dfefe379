"""A handler pass replayed as a graph (``core/graph.py``), on the CPU.

The CPU has no CUDA graphs, so these tests install a stand-in graph
for the CPU (``StandInGraph``). Like a real graph, it writes every
replay's outputs into the tensors its capture made, and the wrapper's
bookkeeping runs as it does on a card: the learning pass, the static
copies and what is copied back into them, the re-captures, the counts,
and the drop at the round loop's end. Under it PHOLD runs solo, as a
two-lane fleet and with active-host compaction, each bit for bit as the
eager run: every state leaf (metrics, ring rows with the per-window
digest words, event buffers, outboxes, the model's counters), the
drained rings and the summaries. A state the round loop has handed on is
never written again, and an output made in the graph's own memory is
handed on as a copy. A marked pass that reads a value back to the host
raises, and the net model's passes are not marked.

Run: ``python -m pytest tests/test_torch_graph.py -q``.
"""

from pathlib import Path
from typing import NamedTuple

import pytest
import torch

from shadow1_tpu_torch.config import compiled as ct
from shadow1_tpu_torch.config.experiment import load_experiment
from shadow1_tpu_torch.consts import K_PHOLD, MS, EngineParams
from shadow1_tpu_torch.core import compact, graph
from shadow1_tpu_torch.core.engine import Engine
from shadow1_tpu_torch.fleet.engine import FleetEngine
from shadow1_tpu_torch.telemetry.ring import drain_ring

ROOT = Path(__file__).resolve().parents[1]
WINDOWS = 6


class StandInGraph:
    """A graph for the CPU: the capture runs the pass once and keeps its
    output tensors; each replay runs it again and writes the outputs into
    those tensors, as a CUDA graph's replay does."""

    captures = replays = 0

    def __init__(self, device):
        self.device = device

    def capture(self, body):
        StandInGraph.captures += 1
        self.body = body
        self.outs = body()
        return self.outs

    def replay(self):
        StandInGraph.replays += 1
        for kept, new in zip(self.outs, self.body()):
            if new is not kept:
                kept.copy_(new)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on the CPU, with the counts at 0 (every engine's closures
    learn their own plans)."""
    monkeypatch.setitem(graph.GRAPHS, "cpu", StandInGraph)
    monkeypatch.setattr(StandInGraph, "captures", 0)
    monkeypatch.setattr(StandInGraph, "replays", 0)
    yield StandInGraph
    graph.release()


def _exp(seed=7, hosts=64, init_events=4, mean_ms=2.0):
    return ct.single_vertex_experiment(
        n_hosts=hosts, seed=seed, end_time=WINDOWS * MS, latency_ns=1 * MS,
        model="phold", model_cfg={"mean_delay_ns": mean_ms * MS,
                                  "init_events": init_events})


def _params(**kw):
    return EngineParams(ev_cap=48, outbox_cap=24, max_rounds=128,
                        metrics_ring=WINDOWS, state_digest=1, **kw)


def _assert_same_state(got, want):
    lg, lw = graph._leaves(got, []), graph._leaves(want, [])
    assert len(lg) == len(lw)
    for i, (a, b) in enumerate(zip(lg, lw)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), i


def _run_solo(exp, params):
    eng = Engine(exp, params, device="cpu")
    st = eng.run(n_windows=WINDOWS)
    return eng, st


def test_solo_phold_replays_bit_for_bit(monkeypatch):
    eager_eng, eager = _run_solo(_exp(), _params())
    with monkeypatch.context() as m:
        m.setitem(graph.GRAPHS, "cpu", StandInGraph)
        m.setattr(StandInGraph, "replays", 0)
        m.setattr(StandInGraph, "captures", 0)
        eng, st = _run_solo(_exp(), _params())
        replays, captures = StandInGraph.replays, StandInGraph.captures
    _assert_same_state(st, eager)
    assert Engine.metrics_dict(st) == Engine.metrics_dict(eager)
    rows = drain_ring(st, eng.window)
    assert rows == drain_ring(eager, eager_eng.window)
    assert any(k.startswith("dg_") for k in rows[0])
    for k, v in eng.model_summary(st).items():
        assert (v == eager_eng.model_summary(eager)[k]).all(), k
    # Every round but the first (the learning pass) is a replay; each
    # window captures anew (its planes are new), and the loop's end drops
    # the graph.
    rounds = Engine.metrics_dict(st)["rounds"]
    assert replays == rounds - 1 and 1 <= captures <= WINDOWS
    assert graph._PASSES == {}


def test_fleet_phold_replays_bit_for_bit(monkeypatch):
    # The second lane stops at its own round cap: the pop's bound per
    # column runs too.
    exps, caps = [_exp(seed=11), _exp(seed=12)], [128, 3]
    eager_eng = FleetEngine(exps, _params(), caps, device="cpu")
    eager = eager_eng.run(n_windows=WINDOWS)
    with monkeypatch.context() as m:
        m.setitem(graph.GRAPHS, "cpu", StandInGraph)
        m.setattr(StandInGraph, "replays", 0)
        eng = FleetEngine(exps, _params(), caps, device="cpu")
        st = eng.run(n_windows=WINDOWS)
        replays = StandInGraph.replays
    _assert_same_state(st, eager)
    assert eng.metrics_per_exp(st) == eager_eng.metrics_per_exp(eager)
    assert eng.drain_rings(st) == eager_eng.drain_rings(eager)
    for e in range(2):
        got, want = eng.model_summary(st, e), eager_eng.model_summary(eager, e)
        for k, v in want.items():
            assert (got[k] == v).all(), (e, k)
    mets = eng.metrics_per_exp(st)
    assert mets[1]["round_cap_hits"] > 0 and mets[0]["round_cap_hits"] == 0
    assert replays == mets[0]["rounds"] - 1


def test_compacted_phold_replays_bit_for_bit(monkeypatch):
    """Compaction builds the handlers anew over each window's bucket, so
    each such window captures its own graph."""
    exp = _exp(hosts=64, init_events=1, mean_ms=6.0)
    params = _params(compact_cap=40)
    _, eager = _run_solo(exp, params)
    with monkeypatch.context() as m:
        m.setitem(graph.GRAPHS, "cpu", StandInGraph)
        m.setattr(StandInGraph, "replays", 0)
        m.setattr(StandInGraph, "captures", 0)
        for k in compact.WINDOWS:
            m.setitem(compact.WINDOWS, k, 0)
        _, st = _run_solo(exp, params)
        windows = dict(compact.WINDOWS)
        replays, captures = StandInGraph.replays, StandInGraph.captures
    assert windows["compact"] > 0, windows
    _assert_same_state(st, eager)
    assert replays > 0 and captures > 0


def test_each_closure_learns_its_own_plan(stand_in):
    """A plan is kept on the handler closure that learned it: a sibling
    closure of the same code, built for another engine, learns its own
    before it is captured."""
    a = Engine(_exp(), _params(), device="cpu")
    b = Engine(_exp(seed=8), _params(), device="cpu")
    fa, fb = a._handlers[K_PHOLD], b._handlers[K_PHOLD]
    assert fa.__code__ is fb.__code__ and fa is not fb
    a.run(n_windows=1)
    assert len(fa.graph_plans) == 1 and fb.graph_plans == {}
    captures = stand_in.captures
    b.run(n_windows=1)
    assert len(fb.graph_plans) == 1
    assert stand_in.captures == captures + 1


def test_a_handed_on_state_is_never_rewritten(stand_in):
    """The aliasing hazard: a replay rewrites its static copies in place,
    and the window's entry metrics (the ring row's baseline) and every
    state a window hands on hold such copies. None may change after."""
    eng = Engine(_exp(), _params(), device="cpu")
    st = eng.init_state()
    kept = []
    for _ in range(WINDOWS):
        st = eng.run(st, n_windows=1)
        kept.append((st, [x.clone() for x in graph._leaves(st, [])]))
    assert stand_in.replays > 0
    for st_w, snap in kept:
        for a, b in zip(graph._leaves(st_w, []), snap):
            assert torch.equal(a, b)


class _St(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


class _Ev(NamedTuple):
    mask: torch.Tensor
    time: torch.Tensor


def test_an_output_made_in_graph_memory_is_handed_on_as_a_copy(stand_in):
    """An output that is no static copy (``b``: never read, made anew)
    lives in the graph's memory, which the next replay rewrites."""

    @graph.capturable
    def twice(st, ev):
        return st._replace(b=ev.time * 2)

    st = _St(a=torch.zeros(4), b=torch.zeros(4, dtype=torch.int64))
    outs = [graph.run_pass(K_PHOLD, twice, st,
                           _Ev(mask=torch.ones(4, dtype=torch.bool),
                               time=torch.full((4,), t)))
            for t in (1, 2, 3)]
    assert stand_in.captures == 1 and stand_in.replays == 2
    assert [o.b.tolist() for o in outs] == [[2] * 4, [4] * 4, [6] * 4]
    assert all(o.a is st.a for o in outs)


def test_a_marked_pass_that_reads_raises(stand_in):
    eng = Engine(_exp(), _params(), device="cpu")
    on_phold = eng._handlers[K_PHOLD]

    def reads(st, ev):
        st = on_phold(st, ev)
        if bool(st.metrics.ev_overflow > 0):
            raise AssertionError("no overflow here")
        return st

    eng._handlers = {K_PHOLD: reads}
    eng.run(n_windows=1)                      # unmarked: eager, it runs
    eng._handlers = {K_PHOLD: graph.capturable(reads)}
    with pytest.raises(RuntimeError, match="back to the host"):
        eng.run(n_windows=1)
    assert stand_in.captures == 0


def test_phold_is_marked_and_the_net_model_is_not():
    eng = Engine(_exp(), _params(), device="cpu")
    assert all(getattr(fn, "capturable", False)
               for fn in eng._handlers.values())
    exp, params, _ = load_experiment(str(ROOT / "configs"
                                         / "rung1_filexfer.yaml"))
    net = Engine(exp, params, device="cpu")
    assert len(net._handlers) > 1
    assert not any(getattr(fn, "capturable", False)
                   for fn in net._handlers.values())

"""The port's ``opcensus`` against the JAX package's.

* the census is deterministic (two runs equal key by key, sources
  included), counts every phase and pass, and the window it counts ran as
  many rounds and events as the JAX engine's same window;
* ``gate_config`` gives the reference's verdicts on the reference's own
  cases (``tests/test_perfobs.py``), the port's ``ops`` read as its
  ``eqns``, and gates ``reads`` by the same rules;
* ``--inject`` adds its ops to ``rounds`` alone and trips the gate there;
* the committed ``cpu`` entry of ``opcensus_baseline.json`` gates ok;
  ``--update`` keeps the other backend's entries; ``--fusion`` is refused
  off the card; without a card and ``--device`` the CLI raises;
* the launch census counts a capture's kernels, copies and the three
  hand-written kernels.
"""

from __future__ import annotations

import io
import json
import shutil
from contextlib import redirect_stdout

import pytest
import torch

from shadow1_tpu.core.engine import Engine as EngineJ
from shadow1_tpu.tools import opcensus as ref
from shadow1_tpu.tools import phaseprobe as ref_pp
from shadow1_tpu_torch.tools import opcensus as port
from shadow1_tpu_torch.tools.phaseprobe import build_engine

HOSTS = 256
WARMUP = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke_census():
    torch.set_num_threads(1)
    eng, _ = build_engine("smoke", hosts=HOSTS, device="cpu")
    return eng, port.census(eng, warmup=WARMUP, sources=True)


def _main(argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = port.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_census_deterministic(smoke_census):
    eng, a = smoke_census
    b = port.census(eng, warmup=WARMUP, sources=True)
    assert a == b
    keys = {"prepare", "rounds", "deliver", "telem", "pop", "h_phold",
            "round"}
    assert set(a["ops"]) == set(a["reads"]) == keys
    assert a["ops"]["rounds"] > a["ops"]["round"] > a["ops"]["pop"] > 0
    # One read per round (the continue test) and the final one.
    assert a["reads"]["rounds"] == a["window"]["rounds"] + 1
    # Source attribution reaches the library layers.
    assert any(s.startswith("events.") for s in a["sources"]["rounds"])
    for name, by in a["sources"].items():
        assert sum(by.values()) == a["ops"][name], name


def test_census_window_matches_the_jax_engine(smoke_census):
    """The counted window (window ``WARMUP``) ran the rounds and events the
    JAX engine's same window runs."""
    _, c = smoke_census
    eng, _ = ref_pp.build_engine("smoke", hosts=HOSTS)
    st = eng.run(eng.init_state(), n_windows=WARMUP)
    m0 = EngineJ.metrics_dict(st)
    m1 = EngineJ.metrics_dict(eng.run(st, n_windows=1))
    assert c["window"] == {"index": WARMUP,
                           "rounds": m1["rounds"] - m0["rounds"],
                           "events": m1["events"] - m0["events"]}
    assert c["window"]["rounds"] > 1


# The cases of tests/test_perfobs.py::test_opcensus_gate_logic.
GATE_CASES = {
    "inside": {"rounds": 420, "deliver": 250},
    "drift": {"rounds": 480, "deliver": 250},
    "vanished": {"deliver": 250},
    "new_phase": {"rounds": 400, "deliver": 250, "extra": 9},
    "shrunk": {"rounds": 300, "deliver": 250},
}
GATE_BASE = {"rounds": 400, "deliver": 250}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_config_matches_the_reference(case):
    m = GATE_CASES[case]
    want = ref.gate_config({"eqns": m}, {"eqns": GATE_BASE}, 0.10)
    got = port.gate_config({"ops": m}, {"ops": GATE_BASE}, 0.10)
    assert [f.replace(" ops", " eqns") for f in got] == want
    # Reads are gated by the same rules, and name their unit.
    got_r = port.gate_config({"ops": GATE_BASE, "reads": m},
                             {"ops": GATE_BASE, "reads": GATE_BASE}, 0.10)
    assert [f.replace(" reads", " eqns") for f in got_r] == want
    assert bool(want) == (case != "inside")


def test_inject_trips_the_gate_on_rounds_only(smoke_census):
    eng, clean = smoke_census
    n = 60
    hot = port.census(eng, warmup=WARMUP, inject=n)
    rounds = clean["window"]["rounds"]
    assert hot["ops"]["rounds"] == clean["ops"]["rounds"] + n * rounds
    assert {k: v for k, v in hot["ops"].items() if k != "rounds"} == \
        {k: v for k, v in clean["ops"].items() if k != "rounds"}
    assert hot["reads"] == clean["reads"]
    fails = port.gate_config(hot, clean, port.TOLERANCE)
    assert fails and all("'rounds'" in f for f in fails), fails
    rc, line = _main(["smoke", "--inject", str(n), "--device", "cpu"])
    assert rc == 1 and line["gate"] == "failed"
    assert [f.split(":")[0] for f in line["fails"]["smoke_phold"]] == \
        ["phase 'rounds'"]


def test_committed_cpu_entry_gates_ok():
    rc, line = _main(["--device", "cpu"])
    assert rc == 0 and line["gate"] == "ok", line
    assert set(line["census"]) == {"smoke_phold", "rung1_filexfer"}
    base = json.load(open(port.BASELINE))
    for label, c in line["census"].items():
        entry = base["configs"][label]["cpu"]
        assert c["ops"] == entry["ops"] and c["reads"] == entry["reads"]
        assert c["window"] == entry["window"]
    r1 = line["census"]["rung1_filexfer"]
    # Every handler pass of the net model, and the TCP reads of a round.
    assert {"h_deliver", "h_timer", "h_txr", "h_app"} <= set(r1["ops"])
    assert r1["reads"]["rounds"] > r1["window"]["rounds"]


def test_update_keeps_the_other_backend(tmp_path):
    path = tmp_path / "b.json"
    shutil.copyfile(port.BASELINE, path)
    base = json.loads(path.read_text())
    base["configs"]["smoke_phold"]["cuda"] = {"ops": {"rounds": 1},
                                              "reads": {"rounds": 1}}
    path.write_text(json.dumps(base))
    rc, line = _main(["smoke", "--update", "--baseline", str(path),
                      "--device", "cpu"])
    assert rc == 0 and line["gate"] == "updated"
    after = json.loads(path.read_text())
    assert after["configs"]["smoke_phold"]["cuda"] == {
        "ops": {"rounds": 1}, "reads": {"rounds": 1}}
    assert after["configs"]["smoke_phold"]["cpu"]["ops"] == \
        line["census"]["smoke_phold"]["ops"]
    assert after["configs"]["rung1_filexfer"] == base["configs"][
        "rung1_filexfer"]


def test_fusion_refused_off_the_card():
    rc, line = _main(["smoke", "--fusion", "--device", "cpu"])
    assert rc == 2 and "card" in line["error"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_and_no_device_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["smoke"])


def test_device_records_count_kernels_copies_and_the_three():
    class Ev:
        def __init__(self, name, dev="DeviceType.CUDA"):
            self._n, self._d = name, dev

        def name(self):
            return self._n

        def device_type(self):
            return self._d

    events = [Ev("void pop_kernel<4>(...)"), Ev("push_kernel"),
              Ev("push_kernel"), Ev("obox_kernel(int*)"),
              Ev("(anonymous namespace)::rx_ack_kernel(TcpPlanes, ...)"),
              Ev("void at::native::elementwise_kernel<128, 2>(...)"),
              Ev("Memcpy DtoH (Device -> Pageable)"), Ev("Memset (Device)"),
              Ev("aten::add", "DeviceType.CPU"),
              Ev("cudaLaunchKernel", "DeviceType.CPU")]
    assert port.device_records(events) == {
        "kernels": 6, "copies": 2, "pop": 1, "push": 2, "obox": 1,
        "rx_ack": 1, "rx_data": 0}

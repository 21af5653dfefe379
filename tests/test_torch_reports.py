"""The port's report tools (``shadow1_tpu_torch/tools/``: heartbeat_report,
flowreport, netreport, captune, pcap) and ``config.experiment.resolve_edges``
against the JAX package's, on the CPU.

* **Same input, same output.** One record file from the port's CLI: rung 1
  supervised under ``--ckpt`` with an injected crash (a respawn, so resume
  and lineage records), two flow probes, link telemetry, heartbeats, the
  ring with its digest words, and ``--on-overflow retry`` under a
  ``SHADOW1_MEM_BYTES`` budget between the halt and the retry peaks (a
  memory downshift record). Both packages' tools read it: the summary
  dicts, the printed text and the CSV bytes are equal.
* The lineage, memory, flow and link sections of the port's
  heartbeat_report are present and not empty over that file.
* The serve section: the reference's ``test_report_serve_section`` on the
  port's tool, and both tools over the log of the port's daemon.
* ``selftest()`` of flowreport and netreport passes, with the reference's
  output.
* ``load_graphml`` reads GraphML without networkx and gives what the
  reference's networkx-based loader gives.
* ``resolve_edges`` over ``configs/topology_2pop.graphml``'s vertices and
  ``PcapWriter`` / ``FilteredPcap`` over the cases of ``tests/test_pcap.py``:
  the reference's results, error texts and bytes.

The port's records against the JAX CLI's records of the same run are
``tests/test_torch_reports_jax.py``. Tolerance: none (text and bytes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from shadow1_tpu.config.experiment import WatchlistError as WatchlistErrorJ
from shadow1_tpu.config.experiment import resolve_edges as resolve_edges_j
from shadow1_tpu.tools import captune as captune_j
from shadow1_tpu.tools import flowreport as flowreport_j
from shadow1_tpu.tools import heartbeat_report as heartbeat_report_j
from shadow1_tpu.tools import netreport as netreport_j
from shadow1_tpu.tools import pcap as pcap_j
from shadow1_tpu_torch.config.experiment import WatchlistError, resolve_edges
from shadow1_tpu_torch.consts import F_ACK, F_DGRAM, F_FIN, F_RST, F_SYN
from shadow1_tpu_torch.tools import (
    captune,
    flowreport,
    heartbeat_report,
    netreport,
    pcap,
)
from tests.test_torch_tgen import _one_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = str(ROOT / "configs" / "rung1_filexfer.yaml")
WINDOWS, CHUNK = 40, 5
WINDOW_NS = 40_000_000
CRASH_WINDOW = 20
FLAGS = ["--windows", str(WINDOWS), "--heartbeat", str(CHUNK),
         "--metrics-ring", "10", "--state-digest", "on",
         "--watch", "server:0", "--watch", "client:0", "--link-telem", "on"]
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "SHADOW1_SUPERVISE_BACKOFF_S": "0"}
PAIRS = {"heartbeat_report": (heartbeat_report, heartbeat_report_j),
         "flowreport": (flowreport, flowreport_j),
         "netreport": (netreport, netreport_j),
         "captune": (captune, captune_j)}


def port_cli(out: Path, *args, env=None) -> subprocess.Popen:
    """The port's CLI on the CPU, stdout to ``out``, stderr to ``out``.err."""
    with open(out, "w") as fo, open(str(out) + ".err", "w") as fe:
        return subprocess.Popen(
            [sys.executable, "-m", "shadow1_tpu_torch", CFG, "--device",
             "cpu", *args], cwd=ROOT, env={**ENV, **(env or {})},
            stdout=fo, stderr=fe)


def finish(proc: subprocess.Popen, out: Path, timeout: float = 600) -> None:
    rc = proc.wait(timeout=timeout)
    assert rc == 0, Path(str(out) + ".err").read_text()[-3000:]


def downshift_budget() -> int:
    """A byte budget between the run's halt and retry peaks: the CLI's
    ``--on-oom downshift`` must drop the rollback copy to fit."""
    from shadow1_tpu_torch import cli, mem
    from shadow1_tpu_torch.config.experiment import load_experiment

    ap = cli._parser()
    args = ap.parse_args([CFG, *FLAGS, "--on-overflow", "retry"])
    exp, params, _ = load_experiment(CFG)
    params = cli._params(ap, args, exp, params)
    retry = mem.estimate(exp, params).peak_bytes
    halt = mem.estimate(exp, dataclasses.replace(
        params, on_overflow="halt")).peak_bytes
    assert halt < retry
    return (halt + retry) // 2


@pytest.fixture(scope="module")
def log(tmp_path_factory) -> str:
    """The supervised port run's records: stdout, then stderr."""
    d = tmp_path_factory.mktemp("reports")
    out = d / "sup.out"
    finish(port_cli(
        out, *FLAGS, "--on-overflow", "retry", "--on-oom", "downshift",
        "--ckpt", str(d / "c.npz"), "--ckpt-every-s", "0",
        env={"SHADOW1_OBS_CRASH_AT_NS": str(CRASH_WINDOW * WINDOW_NS),
             "SHADOW1_MEM_BYTES": str(downshift_budget())}), out)
    path = d / "run.log"
    path.write_text(out.read_text() + Path(str(out) + ".err").read_text())
    return str(path)


def run_main(module, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue()


# (tool, argv after the log path, CSV outputs the argv names)
MODES = [
    ("heartbeat_report", ["--csv", "{d}/hb.csv", "--ring-csv",
                          "{d}/ring.csv"], ["hb.csv", "ring.csv"]),
    ("flowreport", ["--csv", "{d}/flows.csv"], ["flows.csv"]),
    ("flowreport", ["--json"], []),
    ("flowreport", ["--ascii", "--spark-width", "20"], []),
    ("netreport", ["--csv", "{d}/edges.csv"], ["edges.csv"]),
    ("netreport", ["--json"], []),
    ("netreport", ["--heatmap", "csv"], []),
    ("netreport", ["--ascii", "--top", "1"], []),
    ("captune", [], []),
    ("captune", ["--json", "--headroom", "2.0"], []),
]


@pytest.mark.parametrize("tool,argv,csvs", MODES,
                         ids=[f"{m[0]}{' '.join(m[1][:1])}" for m in MODES])
def test_same_records_same_output(log, tmp_path, tool, argv, csvs):
    port, ref = PAIRS[tool]
    args = [log, *(a.format(d=tmp_path) for a in argv)]
    rc_j, text_j = run_main(ref, args)
    bytes_j = {c: (tmp_path / c).read_bytes() for c in csvs}
    for c in csvs:
        (tmp_path / c).unlink()
    rc_t, text_t = run_main(port, args)
    assert rc_t == rc_j == 0
    assert text_t == text_j and text_t.strip()
    for c in csvs:
        assert (tmp_path / c).read_bytes() == bytes_j[c], c
        assert bytes_j[c].count(b"\n") > 1, c


def test_summaries_equal_and_sections_present(log):
    recs = heartbeat_report.load_records(log)
    assert recs == heartbeat_report_j.load_records(log)
    out_t, out_j = io.StringIO(), io.StringIO()
    got = heartbeat_report.summarize(recs, out=out_t)
    want = heartbeat_report_j.summarize(recs, out=out_j)
    assert got == want and out_t.getvalue() == out_j.getvalue()
    assert got["lineage"]["resumes"] >= 1
    assert got["memory"]["downshifts"][0]["action"] == "drop_rollback"
    assert got["memory"]["estimated_peak"] > 0
    # The downshift demoted retry to halt: no retry block.
    assert "retries" not in got
    assert len(got["flows"]) == 2 and got["links"]["edges"] == 2
    text = out_t.getvalue()
    for head in ("== lineage (preemption/resume) ==",
                 "== memory (estimate vs device) ==",
                 "== flows (probe plane) ==", "== links (telemetry plane) ==",
                 "downshift applied: drop_rollback"):
        assert head in text, head
    assert got["ring_records"] >= WINDOWS and got["heartbeats"] > 0


def test_captune_functions_match_reference(log):
    recs = captune.load_records([log])
    assert recs == captune_j.load_records([log])
    assert captune.group_records(recs) == captune_j.group_records(recs)
    peaks = captune.peaks_from_records(recs)
    assert peaks == captune_j.peaks_from_records(recs)
    rows = captune.advise(*peaks)
    assert rows and rows == captune_j.advise(*peaks)
    assert captune.advise_lines(rows) == captune_j.advise_lines(rows)
    assert captune.render_yaml(rows) == captune_j.render_yaml(rows)


@pytest.mark.parametrize("tool", ["flowreport", "netreport"])
def test_selftest(tool):
    port, ref = PAIRS[tool]
    out_t, out_j = io.StringIO(), io.StringIO()
    assert port.selftest(out=out_t) == 0
    assert ref.selftest(out=out_j) == 0
    assert out_t.getvalue() == out_j.getvalue()
    assert json.loads(out_t.getvalue())["selftest"] == "ok"


# -- the serve section --------------------------------------------------------

SERVE_RECS = [
    {"type": "serve", "event": "batch_start", "batch": "b0",
     "cache": "miss", "lanes": 2},
    {"type": "serve", "event": "batch_start", "batch": "b1",
     "cache": "hit", "lanes": 1},
    {"type": "serve", "event": "evict", "batch": "b0", "jobs": ["a"]},
    {"type": "serve_job", "job": "a", "state": "queued", "t": 1.0},
    {"type": "serve_job", "job": "a", "state": "running", "lane": 0,
     "lanes": 2, "cache": "miss", "t": 2.0},
    {"type": "serve_job", "job": "a", "state": "evicted", "t": 3.0},
    {"type": "serve_job", "job": "a", "state": "done", "t": 9.0},
    {"type": "serve_job", "job": "b", "state": "rejected", "t": 1.0},
    {"type": "serve_queue", "event": "enqueue", "job": "a",
     "depth": 1, "bytes": 100, "t": 1.0},
    {"type": "serve_deadline", "job": "c", "kind": "queue_ttl",
     "waited_s": 0.4, "t": 4.0},
    {"type": "serve_retry", "event": "retry", "batch": "b1",
     "jobs": ["a"], "attempt": 1, "backoff_s": 0.5, "t": 5.0},
    {"type": "serve_retry", "event": "bisect", "batch": "b1",
     "jobs": ["a", "c"], "attempt": 2, "t": 6.0},
]


def test_report_serve_section():
    """The reference's ``tests/test_serve.py::test_report_serve_section``
    on the port's tool."""
    out = io.StringIO()
    summary = heartbeat_report.summarize(SERVE_RECS, out=out)
    s = summary["serve"]
    assert s["jobs"] == 2 and s["batches"] == 2
    assert s["cache_hits"] == 1 and s["cache_misses"] == 1
    assert s["evictions"] == 1
    assert s["deadline_expiries"] == 1 and s["batch_retries"] == 1
    assert s["queue_wait_p50_s"] == 1.0  # job a: queued t=1 -> running t=2
    assert s["retries_by_job"] == {"a": 1}
    text = out.getvalue()
    assert "serve (daemon job ledger)" in text
    assert "evicted x1" in text and "wall 8.0s" in text
    assert "queue wait: p50 1.0s" in text
    assert "deadline expiries: 1 (queue_ttl x1, running x0)" in text
    assert "batch retries: 1  bisections: 1" in text
    assert "retries x1" in text


def test_report_over_the_port_daemons_log(tmp_path):
    from shadow1_tpu_torch.serve import client
    from shadow1_tpu_torch.serve.daemon import ServeDaemon

    d = ServeDaemon(str(tmp_path / "spool"), poll_s=0.05, ckpt_every_s=1e9,
                    device="cpu").start()
    try:
        for jid, seed in (("a", 5), ("b", 6)):
            cfg = tmp_path / f"{jid}.yaml"
            cfg.write_text((ROOT / "configs" / "serve_phold.yaml").read_text()
                           .replace("seed: 5", f"seed: {seed}"))
            client.submit(d.spool.root, str(cfg), job_id=jid)
        while d.step():
            pass
    finally:
        d.close()
    log_path = d.spool.log_path
    args = [log_path]
    rc_t, text_t = run_main(heartbeat_report, args)
    rc_j, text_j = run_main(heartbeat_report_j, args)
    assert rc_t == rc_j == 0 and text_t == text_j
    recs = heartbeat_report.load_records(log_path)
    got = heartbeat_report.summarize(recs, out=io.StringIO())
    assert got == heartbeat_report_j.summarize(recs, out=io.StringIO())
    s = got["serve"]
    assert s["jobs"] == 2 and s["batches"] >= 1 and s["cache_misses"] >= 1
    assert "== serve (daemon job ledger) ==" in text_t


# -- resolve_edges ------------------------------------------------------------

def _vertex_names():
    from shadow1_tpu_torch.config.topology import load_graphml

    return load_graphml(str(ROOT / "configs" / "topology_2pop.graphml"))[0]


@pytest.mark.parametrize("entries", [
    ["pop_west:pop_east"], ["pop_east:pop_west", "0:1", "pop_west:pop_east"],
    ["1:1", " pop_west : 1 "], [], ["pop_wst:pop_east"], ["0:2"],
    ["pop_west"], ["pop_west:"], [":pop_east"], ["-1:0"], ["pop_esat:0"],
])
def test_resolve_edges_matches_reference(entries):
    names = _vertex_names()
    assert names == ["pop_west", "pop_east"]
    try:
        want = resolve_edges_j(entries, names)
    except WatchlistErrorJ as e:
        with pytest.raises(WatchlistError) as got:
            resolve_edges(entries, names)
        assert str(got.value) == str(e)
    else:
        assert resolve_edges(entries, names) == want


DIRECTED_GRAPHML = """<?xml version="1.0" encoding="UTF-8"?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key id="lat" for="edge" attr.name="latency" attr.type="double"/>
  <key id="pl" for="edge" attr.name="packetloss" attr.type="double">
    <default>0.01</default></key>
  <graph id="G" edgedefault="directed">
    <node id="a"/><node id="b"/>
    <edge source="a" target="b"><data key="lat">10.0</data></edge>
    <edge source="b" target="a"><data key="lat">25.5</data>
      <data key="pl">0.2</data></edge>
    <edge source="b" target="c"><data key="lat">5.0</data></edge>
    <edge source="c" target="c"><data key="lat">1.0</data></edge>
  </graph>
</graphml>
"""


@pytest.mark.parametrize("name", ["topology_2pop", "directed"])
def test_graphml_without_networkx(tmp_path, monkeypatch, name):
    """The port's ``load_graphml`` reads GraphML with the standard library
    (no networkx, which the card lacks) and gives what the reference's
    networkx-based loader gives."""
    import numpy as np

    from shadow1_tpu.config.topology import load_graphml as load_graphml_j
    from shadow1_tpu_torch.config.topology import load_graphml

    path = ROOT / "configs" / "topology_2pop.graphml"
    if name == "directed":
        path = tmp_path / "d.graphml"
        path.write_text(DIRECTED_GRAPHML)
    want = load_graphml_j(str(path))
    monkeypatch.setitem(sys.modules, "networkx", None)
    got = load_graphml(str(path))
    assert got[0] == want[0] and got[3] == want[3]
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a, b)


# -- pcap ---------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _pkt(ss=0, ds=0, flags=0, seq=0, ack=0, length=0, wnd=0):
    return (0, ss | (ds << 8) | (flags << 16), seq, ack, length, wnd)


PCAP_CASES = {
    "syn": ([(1_500_000_000, 1, 0, _pkt(ss=2, ds=3, flags=F_SYN, seq=7,
                                        wnd=65535), False)], 128),
    "fin_ack_rst": ([(0, 0, 1, _pkt(flags=F_FIN | F_ACK, seq=9, ack=10),
                      False), (0, 1, 0, _pkt(flags=F_RST), False)], 128),
    "wrap_u32": ([(0, 0, 1, _pkt(seq=(1 << 32) + 5, ack=-1 & M32,
                                 flags=F_ACK), False)], 128),
    "dgram": ([(2_000, 4, 5, _pkt(ss=1, ds=2, flags=F_DGRAM, length=100),
                False)], 128),
    "snaplen": ([(0, 0, 1, _pkt(length=1000), False)], 64),
    "dropped": ([(0, 0, 1, _pkt(), True), (0, 0, 1, _pkt(), False)], 128),
    "big_ids": ([(3 * 10**9 + 7, 70000, 65537, _pkt(ss=255, ds=254,
                                                  length=70000), False)], 96),
}


def _capture(module, path, calls, snaplen) -> tuple[bytes, int]:
    with module.PcapWriter(str(path), snaplen=snaplen) as w:
        for c in calls:
            w(*c)
        n = w.n_packets
    return Path(path).read_bytes(), n


@pytest.mark.parametrize("case", sorted(PCAP_CASES))
def test_pcap_writer_bytes(tmp_path, case):
    calls, snaplen = PCAP_CASES[case]
    got = _capture(pcap, tmp_path / "t.pcap", calls, snaplen)
    want = _capture(pcap_j, tmp_path / "j.pcap", calls, snaplen)
    assert got == want and len(got[0]) > 24


FILTER_CALLS = [(0, 3, 1, _pkt(ss=0, ds=2), False),
                (0, 3, 1, _pkt(ss=1, ds=2), False),
                (0, 1, 3, _pkt(ss=5, ds=0), False),
                (0, 7, 1, _pkt(ss=9, ds=0), False),
                (0, 1, 2, _pkt(), False),
                (0, 2, 5, _pkt(), False)]


@pytest.mark.parametrize("watchlist,edges", [
    (((3, 0), (7, -1)), ()), ((), ()), ((), ((1, 0),)),
    (((7, -1),), ((0, 1),)),
])
def test_filtered_pcap_bytes(tmp_path, watchlist, edges):
    host_vertex = [h % 2 for h in range(8)]

    def run(module, name):
        path = tmp_path / name
        with module.FilteredPcap(module.PcapWriter(str(path)), watchlist,
                                 edges, host_vertex) as w:
            for c in FILTER_CALLS:
                w(*c)
            n = w.n_packets
        return path.read_bytes(), n

    got, want = run(pcap, "t.pcap"), run(pcap_j, "j.pcap")
    assert got == want
    with pcap.PcapWriter(str(tmp_path / "x.pcap")) as w:
        with pytest.raises(ValueError, match="host_vertex"):
            pcap.FilteredPcap(w, (), ((0, 1),))

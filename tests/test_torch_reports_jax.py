"""The port's report tools over the port's records against the reference's
tools over the JAX CLI's records of the same run, on the CPU.

Rung 1 with two flow probes, link telemetry, heartbeats and the ring (the
flags of ``tests/test_torch_reports.py``), once through each package's CLI,
the two started together. The sections that depend on the simulation
alone must be equal: the flow and edge totals and stats, every detector's
verdict, the hottest path, the heatmap, captune's advice and YAML, and the
heartbeat report's run totals, drops and ring percentiles. Only the wall
clock and the memory section may differ: each package prices its own
memory model (ROADMAP Queue C), so that section is held to being present
in both. Tolerance: none.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

from shadow1_tpu.tools import captune as captune_j
from shadow1_tpu.tools import flowreport as flowreport_j
from shadow1_tpu.tools import heartbeat_report as heartbeat_report_j
from shadow1_tpu.tools import netreport as netreport_j
from shadow1_tpu_torch.tools import (
    captune,
    flowreport,
    heartbeat_report,
    netreport,
)
from tests.test_torch_reports import CFG, ENV, FLAGS, ROOT, finish, port_cli

# heartbeat_report summary keys that read the wall clock.
WALL = ("wall_s", "events_per_sec_mean", "sim_per_wall_mean")


@pytest.fixture(scope="module")
def logs(tmp_path_factory) -> dict[str, str]:
    """{"port": the port CLI's records, "jax": the JAX CLI's}: each run's
    stdout and stderr in one file (the port streams its records on
    stdout, the JAX package on stderr)."""
    d = tmp_path_factory.mktemp("reports_jax")
    jax_out = d / "jax.out"
    with open(jax_out, "w") as fo, open(str(jax_out) + ".err", "w") as fe:
        jax_cli = subprocess.Popen(
            [sys.executable, "-m", "shadow1_tpu", CFG, *FLAGS], cwd=ROOT,
            env=ENV, stdout=fo, stderr=fe)
    port_out = d / "port.out"
    finish(port_cli(port_out, *FLAGS), port_out)
    finish(jax_cli, jax_out, timeout=900)
    paths = {}
    for name, out in (("port", port_out), ("jax", jax_out)):
        paths[name] = str(d / f"{name}.log")
        Path(paths[name]).write_text(out.read_text()
                                     + Path(str(out) + ".err").read_text())
    return paths


def test_flow_sections_equal(logs):
    got = flowreport.group_flows(flowreport.load_records(logs["port"]))
    want = flowreport_j.group_flows(flowreport_j.load_records(logs["jax"]))
    assert got == want and len(got) == 2
    for key, rows in got.items():
        assert flowreport.flow_stats(rows) == flowreport_j.flow_stats(rows)
        assert (flowreport.diagnose_flow(rows)
                == flowreport_j.diagnose_flow(want[key]))
    out_t, out_j = io.StringIO(), io.StringIO()
    flowreport.report(got, out=out_t)
    flowreport_j.report(want, out=out_j)
    assert out_t.getvalue() == out_j.getvalue()


def test_edge_sections_equal(logs):
    got = netreport.group_edges(netreport.load_records(logs["port"]))
    want = netreport_j.group_edges(netreport_j.load_records(logs["jax"]))
    assert got == want and len(got) == 2
    totals = netreport.edge_totals(got)
    assert totals == netreport_j.edge_totals(want)
    assert netreport.diagnose_links(got) == netreport_j.diagnose_links(want)
    assert netreport.hottest_path(totals) == netreport_j.hottest_path(totals)
    assert (netreport.heatmap_lines(totals)
            == netreport_j.heatmap_lines(totals))
    out_t, out_j = io.StringIO(), io.StringIO()
    netreport.report(got, out=out_t)
    netreport_j.report(want, out=out_j)
    assert out_t.getvalue() == out_j.getvalue()


def test_captune_advice_equal(logs):
    rows_t = captune.advise(*captune.peaks_from_records(
        captune.load_records([logs["port"]])))
    rows_j = captune_j.advise(*captune_j.peaks_from_records(
        captune_j.load_records([logs["jax"]])))
    assert rows_t and rows_t == rows_j
    assert captune.render_yaml(rows_t) == captune_j.render_yaml(rows_j)
    assert captune.advise_lines(rows_t) == captune_j.advise_lines(rows_j)


def test_heartbeat_summaries_equal_but_the_wall_clock(logs):
    got = heartbeat_report.summarize(
        heartbeat_report.load_records(logs["port"]), out=io.StringIO())
    want = heartbeat_report_j.summarize(
        heartbeat_report_j.load_records(logs["jax"]), out=io.StringIO())
    assert set(got) == set(want)
    for k in (*WALL, "memory"):
        assert got.pop(k) and want.pop(k), k
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["flows"] and got["links"]["edges"] == 2 and got["captune"]

"""``BENCHMARK.json`` against the benchmark's rules, and the files it names.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank)$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    for kind in ("config", "workload", "end_to_end", "per_layer"):
        entries = MANIFEST["configs" if kind == "config" else
                           "workloads" if kind == "workload" else kind]
        for e in entries:
            extra = set(e) - KEYS[kind]
            assert set(e) >= KEYS[kind] and extra <= {"workloads"}, e
            if kind in ("config", "workload"):
                assert "workloads" not in e, e


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths), w
            assert (ROOT / w).exists()


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and group in ("configs", "workloads", "per_layer"):
                    assert line(e[k]), (e["name"], k)
    for group in ("configs", "workloads"):
        assert len({n for g, n in names if g == group}) == len(
            [n for g, n in names if g == group])
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)


def test_configs_and_their_files():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
            assert k in doc["cuts"], k
        assert line(c["source"])
        for k in ("experiment", "guarantees", "reference", "control",
                  "assumed"):
            assert k in doc, (c["name"], k)
        assert (BENCH / "reference" / doc["reference"]).exists() or (
            BENCH / "reference" / f"{doc['reference']}.py").exists()


def test_cells():
    pairs = set()
    four = 0
    for w in MANIFEST["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert line(w["why"])
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["lanes"] >= 1 and cell["span_windows"] >= 1
        assert cell["start_window"] >= 0
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers: dict[str, str] = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in SOURCES
        assert m["moves"] in e2e
        assert line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"].lower(), m["layer"])
        assert layers[m["layer"].lower()] == m["layer"]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = {m["moves"] for m in MANIFEST["per_layer"]
                    if w in m.get("workloads", cells)}
        assert reported, w
        assert any(w in m.get("workloads", cells) and m["name"] != "setup_s"
                   for m in e2e.values())


def test_run_seconds_fit_a_full_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    total = ((2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200)
    assert total <= 43200, total


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]])
def test_reader_returns_nothing_without_records(name):
    from portbench.harness import load_reader

    read = load_reader(name)
    empty = {"walls": [1.0], "rounds": 0, "windows": 1, "pop_bytes": [],
             "hbm_bytes_per_s": 3.35e12,
             "census": {"ops": 0, "reads": 0},
             "profile": {"phase_s": {}, "kernel_records": {"pop": 0},
                         "kernel_s": {"pop": 0.0, "push": 0.0, "obox": 0.0},
                         "device_sum_s": 0.0, "busy_s": 0.0,
                         "window_s": 1.0}}
    v = read(empty)
    assert v is None or (isinstance(v, float) and math.isfinite(v))
    if name.endswith(("_pct",)):
        assert v is None

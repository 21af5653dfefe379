"""One run of one benchmark cell of ``shadow1_tpu_torch`` (``run.py``).

A cell (``workloads/<name>.json``) names a configuration
(``configs/<config>.json``: the experiment document the port compiles, its
source, cuts, guarantees, reference and control), a lane count (1: one
experiment through ``Engine``; more: a seed sweep through ``FleetEngine``,
lane i running seed ``--seed`` + i), a start window and a span of windows.

Set-up compiles the experiment, builds the engine, runs ``init_state`` and
the windows before the start window, keeps a device copy of that start
state and runs one warm pass. The timed window then runs whole passes
back to back, each from a fresh clone of the start state through
``Engine.run``, until ``--seconds`` of pass time are spent; the clock
stops only while the clone is made and the pass's counters are read. Every
pass does the same simulated work, so two trees are timed on identical
work.

The passes run the configuration as its document states it, with the
telemetry ring on for the per-window counters and no state digest. After
the window the last pass's output (per lane: the ``Metrics``, the ring's
rows, the model summary, and the digest words of the state the pass ended
in, taken once after the clock has stopped) is held to the plain reference
(``reference/``), which compiles the same configuration itself and runs
windows 0 to the pass's end. With
``--trace 1`` four more passes follow the window (``tracing.py``): two
under ``torch.profiler``, one under an operation-counting dispatch mode,
and one with the pop kernel's arguments kept for its byte bound; the
per-layer metrics (``metrics/<name>.py``) read their records.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent

# Top-level module names the run must never hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "shadow1_tpu")

# Process exit codes other than 0: no result line is printed with them.
EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4
EXIT_USAGE = 2


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: the kernel's start
    time in clock ticks against the uptime), so set-up counts the
    interpreter's start and ``import torch``."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


def forbidden_modules() -> list[str]:
    """The modules in ``sys.modules`` whose top-level name (before the
    first dot) is one of ``FORBIDDEN``, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: dict, root: Path = ROOT) -> dict:
    """The cell's manifest entry merged with its workload file, its
    configuration file and the metric lists that apply to it."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(root / "portbench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {wl[key]!r} "
                             f"differs from BENCHMARK.json's {entry[key]!r}")
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == entry["config"])
    cfg = load_json(root / cfg_entry["file"])

    def applies(m):
        return name in m.get("workloads", [name])

    return {**wl, "name": name, "chips": entry["chips"], "cfg": cfg,
            "end_to_end": [m for m in manifest["end_to_end"] if applies(m)],
            "per_layer": [m for m in manifest["per_layer"] if applies(m)]}


# -- state handling ----------------------------------------------------------

def clone_tree(x):
    """A deep copy of a state tree: every tensor cloned, the containers
    (NamedTuples, tuples, lists, dicts) rebuilt."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lane_metrics(st, lanes: int) -> list[dict[str, int]]:
    """Per-lane ``Metrics`` as dicts (one device→host copy)."""
    import torch

    names = st.metrics._fields
    arr = torch.stack([v.reshape(-1) for v in st.metrics]).cpu().numpy()
    return [{k: int(arr[i, e]) for i, k in enumerate(names)}
            for e in range(lanes)]


# The digest words of a pass's final state: every subsystem's but the
# outbox's, which the window's delivery has emptied.
FINAL_WORDS = ("dg_evbuf", "dg_tcp", "dg_nic", "dg_rng")


def final_digests(eng, st, lanes: int) -> list[dict[str, int]]:
    """Per lane, the digest words of the state ``st`` (the timed pass runs
    without the per-window digest; this hashes its end once)."""
    import torch

    from shadow1_tpu_torch.core.digest import SUBSYSTEMS, state_digests

    n = getattr(eng.ctx, "n_exp", 0)
    empty = torch.zeros((n,) if n else (), dtype=torch.int64,
                        device=eng.ctx.hosts.device)
    words = state_digests(st, eng.ctx, empty).reshape(lanes, -1).tolist()
    return [{f"dg_{s}": int(w[i]) for i, s in enumerate(SUBSYSTEMS)
             if f"dg_{s}" in FINAL_WORDS} for w in words]


def final_words(out: dict) -> dict[str, int]:
    """The final state's digest words of one lane's output: the program's
    as ``final_digests`` took them, a reference's from its last row."""
    if "digest" in out:
        return out["digest"]
    last = max(out["ring"], key=lambda r: r["window"], default={})
    return {k: last.get(k) for k in FINAL_WORDS}


def lane_outputs(eng, st, lanes: int) -> list[dict]:
    """What the pass produced, per lane: metrics, ring rows, summary and
    the final state's digest words."""
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    mets = lane_metrics(st, lanes)
    words = final_digests(eng, st, lanes)
    out = []
    if lanes > 1:
        rows = eng.drain_rings(st)
        for e in range(lanes):
            out.append({
                "metrics": mets[e],
                "ring": [r for r in rows
                         if r["exp"] == e and r["type"] == "ring"],
                "summary": eng.model_summary(st, e),
                "digest": words[e]})
    else:
        out.append({"metrics": mets[0],
                    "ring": [r for r in drain_ring(st, eng.window)
                             if r["type"] == "ring"],
                    "summary": eng.model_summary(st),
                    "digest": words[0]})
    return out


def pass_rounds(outputs: list[dict], start: int, end: int) -> int:
    """Round iterations the engine ran over windows [start, end): per
    window the most rounds any lane ran (the fleet's loop runs while some
    lane is active, and each active lane counts the round); a window with
    no row counts none."""
    total = 0
    for w in range(start, end):
        total += max(next((r["rounds"] for r in o["ring"]
                           if r["window"] == w), 0) for o in outputs)
    return total


# -- the run -----------------------------------------------------------------

class Cell:
    """The engine of one cell, its start state, and the pass."""

    def __init__(self, cell: dict, seed: int, device):
        import torch

        from shadow1_tpu_torch.config.experiment import build_experiment

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.lanes = int(cell["lanes"])
        self.start = int(cell["start_window"])
        self.span = int(cell["span_windows"])
        doc = copy.deepcopy(cell["cfg"]["experiment"])
        if self.lanes > 1:
            from shadow1_tpu_torch.fleet.engine import FleetEngine
            from shadow1_tpu_torch.fleet.expand import expand_sweep_docs

            doc["sweep"] = {"count": self.lanes, "base_seed": seed}
            built = [build_experiment(d) for d in expand_sweep_docs(doc)]
            self.eng = FleetEngine([b[0] for b in built], built[0][1],
                                   device=self.device)
        else:
            from shadow1_tpu_torch.core.engine import Engine

            doc.setdefault("general", {})["seed"] = seed
            exp, params, _ = build_experiment(doc)
            self.eng = Engine(exp, params, device=self.device)
        self.seeds = [seed + i for i in range(self.lanes)]
        held = [self.eng.init_state()]
        st = self.eng.run(held.pop(), self.start)
        synchronize(self.device)
        alloc0 = self._allocated()
        # The harness's own start copy: every pass runs from a clone of it.
        self.start_state = clone_tree(st)
        synchronize(self.device)
        self.start_bytes = self._allocated() - alloc0
        self.start_metrics = lane_metrics(self.start_state, self.lanes)
        # The warm pass runs on the state the set-up produced.
        held = [st]
        del st
        self.result = self.eng.run(held.pop(), self.span)
        synchronize(self.device)

    def _allocated(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return torch.cuda.memory_allocated(self.device)

    def run_pass(self):
        """One pass from a clone of the start state: (state, wall s)."""
        self.result = None
        held = [clone_tree(self.start_state)]
        synchronize(self.device)
        t0 = time.perf_counter()
        st = self.eng.run(held.pop(), self.span)
        synchronize(self.device)
        return st, time.perf_counter() - t0

    def pass_record(self, st) -> dict:
        mets = lane_metrics(st, self.lanes)
        return {
            "metrics": mets,
            "events": sum(m["events"] - m0["events"]
                          for m, m0 in zip(mets, self.start_metrics)),
            "failed": sum(int(m["ev_overflow"] > m0["ev_overflow"]
                              or m["ob_overflow"] > m0["ob_overflow"]
                              or m["x2x_overflow"] > m0["x2x_overflow"])
                          for m, m0 in zip(mets, self.start_metrics)),
        }


def timed_window(cell: Cell, seconds: float) -> dict:
    """Whole passes until ``seconds`` of pass time are spent. The last
    pass's state is kept in ``cell.result``."""
    walls, recs = [], []
    while True:
        st, wall = cell.run_pass()
        walls.append(wall)
        recs.append(cell.pass_record(st))
        if sum(walls) >= seconds:
            cell.result = st
            return {"walls": walls, "records": recs}
        del st


def window_metrics(cell: Cell, win: dict) -> dict:
    """The end-to-end numbers of the window."""
    wall = sum(win["walls"])
    events = sum(r["events"] for r in win["records"])
    return {"events_per_s": events / wall, "pass_wall_s": wall,
            "passes": len(win["walls"]), "events": events,
            "sim_s_per_wall_s": (len(win["walls"]) * cell.lanes * cell.span
                                 * cell.eng.window / 1e9) / wall}


def compare_outputs(got: list[dict], want: list[dict]) -> dict[str, int]:
    """Counts of compared values that differ, per kind: the metric fields
    the reference reports, every field but the digest words of every ring
    row it reports (by window), every element of every summary array, and
    the final state's digest words (``FINAL_WORDS``)."""
    import numpy as np

    diff = {"metric_fields": 0, "ring_fields": 0, "summary_values": 0,
            "digest_words": 0}
    for g, w in zip(got, want, strict=True):
        for k, v in w["metrics"].items():
            diff["metric_fields"] += int(g["metrics"].get(k) != v)
        rows = {r["window"]: r for r in g["ring"]}
        for wr in w["ring"]:
            gr = rows.get(wr["window"], {})
            diff["ring_fields"] += sum(int(gr.get(k) != v)
                                       for k, v in wr.items()
                                       if not k.startswith("dg_"))
        gw, ww = final_words(g), final_words(w)
        diff["digest_words"] += sum(int(gw.get(k) != ww[k])
                                    for k in FINAL_WORDS)
        for k, v in w["summary"].items():
            a, b = np.asarray(g["summary"].get(k)), np.asarray(v)
            if a.shape != b.shape:
                diff["summary_values"] += max(a.size, b.size, 1)
            else:
                diff["summary_values"] += int((a != b).sum())
    return diff


def reference_module(name: str):
    import importlib

    return importlib.import_module(f"portbench.reference.{name}")


def check(cell: Cell, outputs: list[dict], win: dict, device) -> dict:
    """``{name: (value, limit)}`` for every number compared: the pass
    output against the reference, and the passes against one another."""
    ref = reference_module(cell.cell["cfg"]["reference"])
    want = ref.expected(cell.cell["cfg"]["experiment"], cell.seeds,
                        cell.start + cell.span, device=device)
    checks = {k: (v, 0) for k, v in compare_outputs(outputs, want).items()}
    first = win["records"][0]["metrics"]
    checks["pass_drift"] = (sum(int(r["metrics"] != first)
                                for r in win["records"][1:]), 0)
    return checks


def load_reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             manifest: dict | None = None, root: Path = ROOT,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """Set-up, the timed window, the traced passes and the check of one
    run. Returns the result line's object, ``checks`` its last key."""
    import torch

    manifest = manifest or load_json(root / "BENCHMARK.json")
    cell_spec = load_cell(name, manifest, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cell = Cell(cell_spec, seed, dev)
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s: {cell.lanes} lane(s), windows 0-"
        f"{cell.start - 1} and a warm pass of {cell.span} windows; start "
        f"copy {cell.start_bytes} B")

    win = timed_window(cell, seconds)
    e2e = window_metrics(cell, win)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log(f"window: {e2e['passes']} passes, {e2e['events']} events in "
        f"{e2e['pass_wall_s']:.6f} s = {e2e['events_per_s']:.3f} events/s; "
        f"{e2e['sim_s_per_wall_s']:.9f} simulated s per wall s (lanes "
        f"summed); pass walls {[round(w, 6) for w in win['walls']]}")
    outputs = lane_outputs(cell.eng, cell.result, cell.lanes)
    rounds = pass_rounds(outputs, cell.start, cell.start + cell.span)
    records = {"cell": cell_spec, "walls": win["walls"], "rounds": rounds,
               "windows": cell.span, "lanes": cell.lanes, "device": dev}
    if trace:
        from portbench import tracing

        records.update(tracing.traced_passes(cell))
    attempted = len(win["walls"]) * cell.lanes
    failed = sum(r["failed"] for r in win["records"])
    # The program's state is freed before the reference runs.
    cell.result = cell.start_state = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check(cell, outputs, win, dev)
    log(f"reference: {time.perf_counter() - t0:.3f} s")
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    if trace:
        for m in cell_spec["per_layer"]:
            v = load_reader(m["name"])(records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"events_per_s": e2e["events_per_s"],
                  "peak_mem_gib": (peak - cell.start_bytes) / 2**30,
                  "setup_s": setup_s}
        for m in cell_spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else dev.type),
                  "count": cell_spec["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_rec}
    if trace:
        device_rec["busy_s"] = records["busy_s"]
        device_rec["window_s"] = records["window_s"]
        out["breakdown"] = records["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    manifest = load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return EXIT_USAGE
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", manifest)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0

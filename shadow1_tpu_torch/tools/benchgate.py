"""Per-PR perf regression gate, per row (port of ``tools/benchgate.py``).

    python -m shadow1_tpu_torch.tools.benchgate            # gate vs the baseline
    python -m shadow1_tpu_torch.tools.benchgate --update   # re-baseline (this backend)
    python -m shadow1_tpu_torch.tools.benchgate --rows phold_smoke
    python -m shadow1_tpu_torch.tools.benchgate --device cpu

Three rows, measured as the reference measures them:

* ``phold_smoke``  — dense PHOLD (2,048 hosts, bench.py's smoke shape): the
  per-round fixed cost;
* ``sparse_rung1`` — the rung-1 filexfer config: sparse TCP-heavy rounds;
* ``fleet_smoke``  — the ``configs/sweep_phold.yaml`` 4-lane sweep as one
  ``FleetEngine``: the fleet axis's per-round cost.

Each row gates **ms per inner round** (minimum over timed chunks, after a
warm-up chunk that builds the kernels) against the committed baseline,
recorded PER BACKEND per row; rows without a baseline for this backend
report ``no_baseline_for_backend`` (commit one from that machine with
--update, which merges: other backends' entries are preserved).

* measured > baseline × (1 + tolerance) → exit 1;
* intentional trade-off? the one-line override
  ``SHADOW1_BENCH_GATE_ACCEPT="why"`` turns the failure into a warning —
  then commit the new baseline with ``--update``;
* a big improvement prints a reminder to re-baseline (non-fatal).

Three differences from the reference:

(a) the baseline file is the port's own, ``benchgate_baseline.json`` beside
    this module; the reference's ``BENCH_GATE.json`` is never read or
    written;
(b) the two configs are read from JSON mirrors kept beside this module
    (``benchgate_configs/``: the machine with the card has no ``pyyaml``),
    whose GraphML path is resolved from the repository root;
(c) the backend key is ``cuda`` or ``cpu``, and on CUDA the host
    fingerprint also names the card and its power limit (a wall-clock
    baseline only gates on the machine it was measured on). Where
    ``/proc/cpuinfo`` has no model name (the card's hosts), the CPU is
    named by its vendor, family and model numbers. Each backend has its own
    per-row tolerances: the reference's for ``cpu``, and for ``cuda`` ones
    set from the spread of the card's runs.

The rows run the port's engines on the caller's device: CUDA unless
``--device`` names another (``core/engine.py resolve_device``; with no
card and no ``--device cpu`` it exits non-zero). A warm-up chunk runs on a
state of its own, since the CUDA kernels update a state's planes in place;
the timed chunks start from a fresh ``init_state``, as the reference's do.

Always prints exactly one JSON line on stdout. Exit 0 (ok, updated, no
baseline), 1 (a row failed the gate), 2 (an unknown row).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
BASELINE = os.path.join(_HERE, "benchgate_baseline.json")

# bench.py's CPU-smoke shape — big enough that the round path dominates,
# small enough for seconds of CI wall.
N_HOSTS = 2048
CHUNK = 20
N_CHUNKS = 4
TOLERANCE = 0.05
ACCEPT_ENV = "SHADOW1_BENCH_GATE_ACCEPT"

SPARSE_CONFIG = "shadow1_tpu_torch/tools/benchgate_configs/rung1_filexfer.json"
FLEET_CONFIG = "shadow1_tpu_torch/tools/benchgate_configs/sweep_phold.json"


def _cpu_model() -> str:
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                info.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    model = info.get("model name", "")
    if model and model.lower() != "unknown":
        return model
    return (f"{info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}")


def host_fingerprint(device) -> str:
    """CPU model + logical core count, and on CUDA the card's name and power
    limit — a wall-clock baseline only gates meaningfully on the machine
    class it was measured on."""
    from shadow1_tpu_torch.tools.perfprobe import card_line

    host = f"{_cpu_model()} x{os.cpu_count()}"
    card = card_line(device)
    return f"{host} | {card}" if card else host


def _time_chunks(eng, st, n_chunks: int, chunk: int,
                 rounds_of) -> tuple[list, list, object]:
    """(walls, rounds-per-chunk, final state) of ``n_chunks`` timed chunks."""
    walls, rounds = [], []
    for _ in range(n_chunks):
        r0 = rounds_of(st)
        t0 = time.perf_counter()
        st = eng.run(st, n_windows=chunk)
        eng.synchronize()
        walls.append(time.perf_counter() - t0)
        rounds.append(rounds_of(st) - r0)
    return walls, rounds, st


def _best_row(walls, rounds) -> tuple[int, float]:
    """Gate on the minimum PER-ROUND cost, not the minimum-wall chunk: a
    chunk can post the smallest wall simply by running fewer rounds."""
    best = min(range(len(walls)), key=lambda i: walls[i] / max(rounds[i], 1))
    return best, walls[best] * 1000 / max(rounds[best], 1)


def _warm(eng, chunk: int) -> float:
    """Wall of a warm-up chunk on a state of its own (kernel build
    included); the timed chunks start from a fresh ``init_state``."""
    t0 = time.perf_counter()
    eng.run(eng.init_state(), n_windows=chunk)
    eng.synchronize()
    return time.perf_counter() - t0


def _rounds_sum(s) -> int:
    return int(s.metrics.rounds.sum())


def measure_phold_smoke(device) -> dict:
    from shadow1_tpu_torch.config.compiled import single_vertex_experiment
    from shadow1_tpu_torch.consts import MS, EngineParams
    from shadow1_tpu_torch.core.engine import Engine

    exp = single_vertex_experiment(
        n_hosts=N_HOSTS, seed=1234, end_time=(N_CHUNKS + 1) * CHUNK * MS,
        latency_ns=1 * MS, model="phold",
        model_cfg={"mean_delay_ns": float(2 * MS), "init_events": 16},
    )
    eng = Engine(exp, EngineParams(ev_cap=48, outbox_cap=24,
                                   max_rounds=128), device=device)
    compile_wall = _warm(eng, CHUNK)
    walls, rounds, st = _time_chunks(eng, eng.init_state(), N_CHUNKS, CHUNK,
                                     _rounds_sum)
    best, ms = _best_row(walls, rounds)
    return {
        "metric": "phold_smoke_ms_per_round",
        "ms_per_round": round(ms, 4),
        "hosts": N_HOSTS,
        "chunk_windows": CHUNK,
        "chunks_timed": N_CHUNKS,
        "rounds_per_chunk": rounds[best],
        "events": int(st.metrics.events),
        "compile_wall_s": round(compile_wall, 3),
        "chunk_walls_s": [round(w, 4) for w in walls],
    }


def _mirror(path: str) -> dict:
    from shadow1_tpu_torch.config.experiment import parse_config

    with open(os.path.join(_REPO, path)) as f:
        return parse_config(f.read())


def measure_sparse_rung1(device) -> dict:
    """The sparse TCP row: rung-1 filexfer, the op-count-bound round regime.
    Few hosts, many rounds/window — ms/round here is pure round-body
    cost."""
    from shadow1_tpu_torch.config.experiment import build_experiment
    from shadow1_tpu_torch.core.engine import Engine

    exp, params, _ = build_experiment(_mirror(SPARSE_CONFIG), base_dir=_REPO)
    eng = Engine(exp, params, device=device)
    # Short chunks, MANY of them: the min over 8 samples is what's stable
    # run-to-run.
    chunk, n_chunks = 30, 8
    compile_wall = _warm(eng, chunk)
    walls, rounds, st = _time_chunks(eng, eng.init_state(), n_chunks, chunk,
                                     _rounds_sum)
    best, ms = _best_row(walls, rounds)
    return {
        "metric": "sparse_rung1_ms_per_round",
        "config": SPARSE_CONFIG,
        "ms_per_round": round(ms, 4),
        "hosts": exp.n_hosts,
        "chunk_windows": chunk,
        "chunks_timed": n_chunks,
        "rounds_per_chunk": rounds[best],
        "events": int(st.metrics.events),
        "compile_wall_s": round(compile_wall, 3),
        "chunk_walls_s": [round(w, 4) for w in walls],
    }


def measure_fleet_smoke(device) -> dict:
    """The fleet row: the 4-lane sweep_phold sweep as ONE ``FleetEngine``.
    ms/round over the aggregate (all-lane) round count."""
    from shadow1_tpu_torch.fleet.engine import FleetEngine
    from shadow1_tpu_torch.fleet.expand import expand_sweep

    plan = expand_sweep(_mirror(FLEET_CONFIG), base_dir=_REPO)
    eng = FleetEngine(plan.exps, plan.params, plan.max_rounds, device=device)
    # Short chunks, many min samples — same noise discipline as the sparse
    # row.
    chunk, n_chunks = 8, 8
    compile_wall = _warm(eng, chunk)
    walls, rounds, st = _time_chunks(eng, eng.init_state(), n_chunks, chunk,
                                     _rounds_sum)
    best, ms = _best_row(walls, rounds)
    return {
        "metric": "fleet_smoke_ms_per_round",
        "config": FLEET_CONFIG,
        "ms_per_round": round(ms, 4),
        "experiments": len(plan.exps),
        "hosts": plan.exps[0].n_hosts,
        "chunk_windows": chunk,
        "chunks_timed": n_chunks,
        "rounds_per_chunk": rounds[best],
        "events": int(st.metrics.events.sum()),
        "compile_wall_s": round(compile_wall, 3),
        "chunk_walls_s": [round(w, 4) for w in walls],
    }


ROWS = {
    "phold_smoke": measure_phold_smoke,
    "sparse_rung1": measure_sparse_rung1,
    "fleet_smoke": measure_fleet_smoke,
}

# Per-row tolerances written at --update time, per backend. ``cpu``: the
# reference's (the sparse row 15 % and the fleet row 10 %, their ~0.1 s
# chunks noisy on a shared container; the dense row the 5 % default).
# ``cuda``: set from the spread of the row's min-of-chunks over separate
# calls on the H100's hosts of one CPU class (the largest ratio to the
# median sample, rounded up to 5 %, plus 5 %): the host moves a round's
# cost by tens of percent between calls, and a row measured late in a
# long process (``chip_smoke.py`` phase 20) reads up to 27 % slower.
ROW_TOLERANCE = {"sparse_rung1": 0.15, "fleet_smoke": 0.10}
CUDA_ROW_TOLERANCE = {"phold_smoke": 0.10, "sparse_rung1": 0.25,
                      "fleet_smoke": 0.40}
BACKEND_TOLERANCE = {"cpu": ROW_TOLERANCE, "cuda": CUDA_ROW_TOLERANCE}


def gate_row(name: str, row: dict, base_entry: dict | None,
             host: str, accept: str | None) -> dict:
    """One row's verdict dict (pure — unit-tested without measuring).
    ``base_entry`` is the baseline for THIS backend (already selected), or
    None when that backend has no committed baseline yet."""
    if base_entry is None:
        return {**row, "gate": "no_baseline_for_backend",
                "hint": f"commit one from this machine: python -m "
                        f"shadow1_tpu_torch.tools.benchgate --update "
                        f"--rows {name}"}
    if base_entry.get("host") and base_entry["host"] != host:
        # A wall-clock baseline from another machine would fail every PR on
        # a slower box (or wave real regressions through on a faster one)
        # with no code change at all. Re-baseline per machine.
        return {**row, "gate": "skipped_host_mismatch",
                "baseline_host": base_entry["host"]}
    tol = float(base_entry.get("tolerance", TOLERANCE))
    ref = float(base_entry["ms_per_round"])
    ratio = row["ms_per_round"] / ref if ref else 1.0
    verdict = {**row, "baseline_ms_per_round": ref,
               "ratio": round(ratio, 4), "tolerance": tol}
    if ratio > 1 + tol:
        if accept:
            return {**verdict, "gate": "accepted", "reason": accept}
        return {**verdict, "gate": "failed"}
    if ratio < 1 - 2 * tol:
        verdict["note"] = "improvement — consider re-baselining (--update)"
    return {**verdict, "gate": "ok"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.benchgate")
    ap.add_argument("--update", action="store_true",
                    help="write the measured rows as the committed baseline "
                         "for THIS backend (benchgate_baseline.json; other "
                         "backends' entries are preserved)")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row subset (default: all of "
                         f"{','.join(ROWS)})")
    ap.add_argument("--baseline", default=BASELINE,
                    help="the baseline file (default: the committed one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu to run on the "
                         "CPU)")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.core.engine import resolve_device

    dev = resolve_device(args.device)
    backend = dev.type
    host = host_fingerprint(dev)
    names = list(ROWS) if not args.rows else args.rows.split(",")
    for n in names:
        if n not in ROWS:
            print(json.dumps({"error": f"unknown row {n!r}",
                              "rows": list(ROWS)}))
            return 2
    measured = {}
    for n in names:
        measured[n] = {**ROWS[n](dev), "backend": backend, "host": host}

    try:
        with open(args.baseline) as f:
            base = json.load(f)
    except OSError:
        base = {}
    base_rows = base.get("rows", {})

    if args.update:
        tols = BACKEND_TOLERANCE.get(backend, {})
        for n, row in measured.items():
            base_rows.setdefault(n, {})[backend] = {
                **row, "tolerance": tols.get(n, TOLERANCE)}
        out = {
            "tolerance": TOLERANCE,
            "note": "benchgate baselines of the port, per row per backend — "
                    "the gate fails when a row's measured ms_per_round "
                    "exceeds its baseline by > tolerance on the same "
                    f"backend+host; override once with {ACCEPT_ENV}, then "
                    "re-baseline with --update (merges: other backends "
                    "kept)",
            "rows": base_rows,
        }
        with open(args.baseline, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
        print(json.dumps({"gate": "updated", "baseline": args.baseline,
                          "backend": backend, "rows": measured}))
        return 0

    if not base_rows:
        print(json.dumps({"gate": "no_baseline", "rows": measured,
                          "hint": "commit one with --update"}))
        return 0
    accept = os.environ.get(ACCEPT_ENV)
    verdicts = {}
    failed = False
    for n, row in measured.items():
        entry = base_rows.get(n, {}).get(backend)
        v = gate_row(n, row, entry, host, accept)
        verdicts[n] = v
        if v["gate"] == "failed":
            failed = True
            print(f"[benchgate] PERF REGRESSION ({n}): "
                  f"{v['ms_per_round']} vs baseline "
                  f"{v['baseline_ms_per_round']} ms/round "
                  f"(+{(v['ratio'] - 1) * 100:.1f}% > "
                  f"{v['tolerance'] * 100:.0f}% tolerance). If "
                  f"intentional, override once: {ACCEPT_ENV}='why' — then "
                  f"re-baseline with --update.", file=sys.stderr,
                  flush=True)
        elif v["gate"] == "accepted":
            print(f"[benchgate] REGRESSION ACCEPTED ({n}: {accept}): "
                  f"{v['ms_per_round']} vs baseline "
                  f"{v['baseline_ms_per_round']} ms/round — commit the new "
                  f"baseline: python -m shadow1_tpu_torch.tools.benchgate "
                  f"--update", file=sys.stderr, flush=True)
        elif v.get("note"):
            print(f"[benchgate] {n}: {v['note']}", file=sys.stderr,
                  flush=True)
    print(json.dumps({"gate": "failed" if failed else "ok",
                      "backend": backend, "rows": verdicts}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Per-phase wall attribution of the window loop (port of
``tools/phaseprobe.py``).

    python -m shadow1_tpu_torch.tools.phaseprobe smoke        # dense phold
    python -m shadow1_tpu_torch.tools.phaseprobe cfg.json     # any config
    python -m shadow1_tpu_torch.tools.phaseprobe cfg.json --device-trace DIR
    python -m shadow1_tpu_torch.tools.phaseprobe smoke --device cpu

The performance attribution plane's wall-clock half (the op-count half is
``tools/opcensus.py``). ``core/engine.window_step`` is the composition of
the ``window_phases`` stage list — prepare (restart resets, work gauges,
the net model's NIC arrival batch, rebase), rounds (the pop + handler
loop), deliver (route + scatter + clear), telem (gauges + the telemetry
ring row). This tool times each stage on its own over window frames
captured from a real run of the config, so every ms per round of the
straight run attributes to a phase:

* **capture** — run N windows stage by stage (the same composition, the
  same states bit for bit), keeping a clone of each stage's input frame
  (the CUDA kernels update the event-buffer, outbox and TCP planes in place,
  so a frame that is kept must be a copy);
* **replay** — each rep walks the captured windows in order: the
  straight window first (``Engine.run`` of one window from a clone of its
  captured start state), then each stage on a fresh clone of its input
  frame, each timed alone and ended by a device synchronise (the clones
  are made before the clock starts). Every window and stage keeps its
  minimum wall over the reps (min, not mean: a shared host's noise only
  ever adds), and the windows' minima are summed. Pairing the straight
  window with its stages keeps a drift of the host's speed from landing
  on one side of the coverage only;
* **total** — the straight windows' sum: the same work as one straight
  ``Engine.run`` over the N windows; rep 0 checks that each straight
  window ends where the staged run's next window starts;
* **coverage** — Σ phase wall / straight wall. The phases PARTITION the
  window, so coverage ≈ 1; the synchronise each timed stage ends with adds
  cost rather than hiding work, so coverage < 0.9 means the attribution is
  broken (the acceptance gate: ``--min-coverage 0.9`` exits 1).

Two sub-phase rows refine the big stages without entering the coverage
sum (they are contained in their parents): ``rounds.pop_est`` (one pop on
each rounds-phase input × the measured rounds per window — the rest of
``rounds`` is the handler passes) and ``deliver.route_est``
(``route_outbox`` alone on the deliver-phase inputs — the rest of
``deliver`` is the destination scatter).

Differences from the reference: eager calls of a stage, timed frame by
frame beside the straight window of the same frame, take the place of a
jitted ``lax.scan`` per phase timed over all frames (on the card, with the
straight run and each stage timed as whole loops over the N windows, the
coverage of one config spread over 0.83-1.21 between runs: the host's
speed drifts by tens of percent between consecutive seconds); no warm-up
call precedes the timed reps (there is nothing to compile: the warm-up
windows have run the same code). Runs on CUDA unless ``--device`` names
another device (``core/engine.py resolve_device``). Configs are YAML or
JSON (the card has no YAML parser: pass JSON there, e.g.
``shadow1_tpu_torch/tools/benchgate_configs/rung1_filexfer.json``).

``--device-trace DIR`` also captures a ``torch.profiler`` trace of one
straight chunk through ``telemetry.profiler.device_trace``: the engine's
``WINDOW_PHASES`` ``record_function`` scopes make the window phases
appear as spans in Perfetto (https://ui.perfetto.dev) over the CUDA
kernels, beside the host-side phase spans (``DIR/phases.trace.json``).

Prints one JSON line on stdout and an aligned human table on stderr;
``--md`` prints the table as markdown.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The dense-phold smoke shape — tools/benchgate.py's phold row, so the
# attribution and the regression gate describe the same program.
SMOKE_HOSTS = 2048
SMOKE_EV_CAP = 48
SMOKE_OUTBOX_CAP = 24

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_config(path: str):
    """(exp, params, scheduler) of a YAML or JSON config. A relative
    GraphML path resolves against the config's directory, else against the
    repository root (the JSON mirrors beside ``tools/benchgate.py`` name
    theirs from the root)."""
    from shadow1_tpu_torch.config.experiment import (
        build_experiment,
        parse_config,
    )

    with open(path) as f:
        doc = parse_config(f.read())
    base = os.path.dirname(os.path.abspath(path))
    g = (doc.get("network") or {}).get("graphml")
    if (isinstance(g, str) and not os.path.isabs(g)
            and not os.path.exists(os.path.join(base, g))):
        base = _REPO
    return build_experiment(doc, base_dir=base)


def build_engine(config: str, metrics_ring: int = 0,
                 hosts: int = SMOKE_HOSTS, device=None):
    """(engine, config_label) for a YAML/JSON path or the built-in
    "smoke", on ``device`` (default CUDA)."""
    import dataclasses

    from shadow1_tpu_torch.consts import MS, EngineParams
    from shadow1_tpu_torch.core.engine import Engine

    if config == "smoke":
        from shadow1_tpu_torch.config.compiled import single_vertex_experiment

        exp = single_vertex_experiment(
            n_hosts=hosts, seed=1234, end_time=10**15,
            latency_ns=1 * MS, model="phold",
            model_cfg={"mean_delay_ns": float(2 * MS), "init_events": 16},
        )
        params = EngineParams(ev_cap=SMOKE_EV_CAP, outbox_cap=SMOKE_OUTBOX_CAP,
                              max_rounds=128, metrics_ring=metrics_ring)
        return Engine(exp, params, device=device), "smoke_phold"
    exp, params, scheduler = load_config(config)
    if scheduler not in (None, "tpu"):
        raise SystemExit(f"phaseprobe attributes the single-device window "
                         f"loop; config asks for scheduler={scheduler!r}")
    if metrics_ring:
        params = dataclasses.replace(params, metrics_ring=metrics_ring)
    return Engine(exp, params, device=device), os.path.basename(config)


def clone_tree(x):
    """A copy of every tensor of a frame or state tree (NamedTuples,
    tuples, lists, dicts); other leaves (``cap_hit``'s bool, None) as
    they are."""
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


def engine_phases(eng):
    """The engine's (name, frame → frame) stage list (``window_phases``
    with the engine's handlers and hooks)."""
    from shadow1_tpu_torch.core.engine import window_phases

    return window_phases(eng.ctx, eng._handlers, eng._model.make_handlers,
                         eng._pre_window)


def capture_frames(eng, st0, n_windows: int):
    """Run ``n_windows`` stage by stage from ``st0``, keeping a clone of
    each stage's input frame. Returns (phases, {name: [frames]}, final
    state). The staged composition IS window_step, so the final state
    matches the straight run's bit for bit. On CUDA the kernels update
    ``st0``'s planes in place: pass a clone to keep it."""
    from shadow1_tpu_torch.core.engine import window_frame

    phases = engine_phases(eng)
    inputs = {name: [] for name, _ in phases}
    st = st0
    for _ in range(n_windows):
        fr = window_frame(st, eng.ctx)
        for name, fn in phases:
            inputs[name].append(clone_tree(fr))
            fr = fn(fr)
        st = fr.st
    return phases, inputs, st


def _timed(fn, args, eng):
    """(wall, result) of ``fn(args)``, ending in a device synchronise;
    ``args`` (fresh clones) were made before the clock starts."""
    eng.synchronize()
    t0 = time.perf_counter()
    out = fn(args)
    eng.synchronize()
    return time.perf_counter() - t0, out


def _replay(fn):
    """The stage mapped over a list of frames, eagerly, in order."""
    def run(frames):
        for fr in frames:
            fn(fr)
    return run


def attribution(eng, n_windows: int = 16, warmup: int = 8, reps: int = 3,
                subphases: bool = True) -> dict:
    """The per-config attribution table: phase → ms/window, ms/round, % of
    the straight run, plus total/coverage. Importable (tests and
    ``chip_smoke.py`` assert on the returned dict); the CLI below is a
    thin printer around it.

    The timing is paired window by window: each rep runs, for every
    captured window in turn, the straight window (``Engine.run`` of one
    window from a clone of its captured start state) and then each phase
    on a clone of its captured input frame, each timed alone and ended by
    a device synchronise. A drift of the host's speed (tens of percent
    between consecutive seconds on a shared host) thus moves both sides
    of the coverage alike; every window and phase keeps its minimum over
    the reps, and the windows' minima are summed."""
    from shadow1_tpu_torch.convert import clone_state
    from shadow1_tpu_torch.core.engine import Engine

    st0 = eng.run(eng.init_state(), n_windows=warmup)
    eng.synchronize()
    m0 = Engine.metrics_dict(st0)

    # The staged run first: its final state is the straight run's.
    phases, frames, st_cap = capture_frames(eng, st0, n_windows)
    m1 = Engine.metrics_dict(st_cap)
    del st_cap, st0
    starts = [fr.st for fr in frames[phases[0][0]]]
    # The straight window i must end where the staged run's window i + 1
    # starts — the attribution is meaningless if the staged states drifted.
    ends = [Engine.metrics_dict(st) for st in starts[1:]] + [m1]
    straight = [float("inf")] * n_windows
    walls = {name: [float("inf")] * n_windows for name, _ in phases}
    for rep in range(reps):
        for i in range(n_windows):
            wall, st = _timed(lambda s: eng.run(s, n_windows=1),
                              clone_state(starts[i]), eng)
            straight[i] = min(straight[i], wall)
            if rep == 0:
                assert Engine.metrics_dict(st) == ends[i], (
                    "staged composition diverged from window_step — "
                    "phase refactor bug")
            del st
            for name, fn in phases:
                wall, _ = _timed(fn, clone_tree(frames[name][i]), eng)
                walls[name][i] = min(walls[name][i], wall)
    total_s = sum(straight)
    rounds = m1["rounds"] - m0["rounds"]
    rpw = rounds / n_windows
    total_ms_w = total_s * 1e3 / n_windows
    out = {
        "windows": n_windows,
        "reps": reps,
        "rounds_per_window": round(rpw, 2),
        "ms_per_window": round(total_ms_w, 4),
        "ms_per_round": round(total_s * 1e3 / max(rounds, 1), 4),
        "events": m1["events"] - m0["events"],
        "phases": {},
        "subphases": {},
    }
    phase_sum = 0.0
    for name, _ in phases:
        wall = sum(walls[name])
        ms_w = wall * 1e3 / n_windows
        phase_sum += ms_w
        out["phases"][name] = {
            "ms_per_window": round(ms_w, 4),
            "ms_per_round": round(wall * 1e3 / max(rounds, 1), 4),
            "pct": round(100 * ms_w / total_ms_w, 1) if total_ms_w else None,
        }
    out["phases_ms_per_window"] = round(phase_sum, 4)
    out["coverage"] = round(phase_sum / total_ms_w, 3) if total_ms_w else None

    if subphases:
        # Contained estimates (never in the coverage sum): the pop and the
        # routing gather alone on the frames they actually see, each as one
        # loop over the frames with one synchronise at its end.
        from shadow1_tpu_torch.core.engine import route_outbox
        from shadow1_tpu_torch.core.popk import pop_until

        extract = eng.ctx.params.pop_extract

        def pop_fn(fr):
            pop_until(fr.st.evbuf, fr.win_end, extract=extract)

        def route_fn(fr):
            route_outbox(eng.ctx, fr.st.outbox)

        pop_wall = min(_timed(_replay(pop_fn), clone_tree(frames["rounds"]),
                              eng)[0] for _ in range(reps))
        route_wall = min(_timed(_replay(route_fn), frames["deliver"], eng)[0]
                         for _ in range(reps))
        out["subphases"]["rounds.pop_est"] = {
            "ms_per_window": round(pop_wall * 1e3 * rpw / n_windows, 4),
            "ms_per_round": round(pop_wall * 1e3 / n_windows, 4),
            "note": "one pop x measured rounds/window",
        }
        out["subphases"]["deliver.route_est"] = {
            "ms_per_window": round(route_wall * 1e3 / n_windows, 4),
            "ms_per_round": round(route_wall * 1e3 / max(rounds, 1), 4),
            "note": "route_outbox alone on the deliver-phase inputs",
        }
    return out


def _table(label: str, att: dict, md: bool = False) -> str:
    rows = [("phase", "ms/window", "ms/round", "% of round")]
    for name, d in att["phases"].items():
        rows.append((name, f"{d['ms_per_window']:.3f}",
                     f"{d['ms_per_round']:.3f}", f"{d['pct']:.1f}%"))
    for name, d in att["subphases"].items():
        rows.append((f"  {name}", f"{d['ms_per_window']:.3f}",
                     f"{d['ms_per_round']:.3f}", "(contained)"))
    rows.append(("TOTAL (straight run)", f"{att['ms_per_window']:.3f}",
                 f"{att['ms_per_round']:.3f}", "100%"))
    rows.append(("coverage (Σ phases / total)", "", "",
                 f"{att['coverage'] * 100:.1f}%"))
    lines = [f"== phase attribution: {label} "
             f"({att['windows']} windows, {att['rounds_per_window']} "
             f"rounds/window) =="]
    if md:
        lines = [f"| {' | '.join(rows[0])} |",
                 "|" + "---|" * len(rows[0])]
        lines += [f"| {' | '.join(r)} |" for r in rows[1:]]
        return "\n".join(lines)
    width = [max(len(r[i]) for r in rows) for i in range(4)]
    for r in rows:
        lines.append("  " + "  ".join(c.ljust(w) for c, w in zip(r, width)))
    return "\n".join(lines)


def device_trace_run(eng, log_dir: str, n_windows: int, warmup: int) -> None:
    """One straight chunk of ``n_windows`` after ``warmup`` windows under
    ``telemetry.device_trace`` (``log_dir/trace.json``), with the host
    spans of a PhaseProfiler in ``log_dir/phases.trace.json``."""
    from shadow1_tpu_torch.telemetry import PhaseProfiler, device_trace

    prof = PhaseProfiler()
    st0 = eng.run(eng.init_state(), n_windows=warmup)
    eng.synchronize()
    with device_trace(log_dir, profiler=prof):
        eng.run(st0, n_windows=n_windows)
        eng.synchronize()
    prof.write(os.path.join(log_dir, "phases.trace.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.phaseprobe")
    ap.add_argument("config", help='YAML/JSON experiment file or "smoke" '
                                   "(the benchgate dense-phold shape)")
    ap.add_argument("--windows", type=int, default=16,
                    help="windows to capture and attribute (default 16)")
    ap.add_argument("--warmup", type=int, default=8,
                    help="windows run before capture (state realism)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing reps; min wall is reported")
    ap.add_argument("--hosts", type=int, default=SMOKE_HOSTS,
                    help="host count for the smoke config")
    ap.add_argument("--metrics-ring", type=int, default=0,
                    help="attribute with a W-deep telemetry ring (the telem "
                         "phase is ~empty without one)")
    ap.add_argument("--min-coverage", type=float, default=0.0,
                    help="exit 1 when Σ phases / total falls below this "
                         "(0.9 is the acceptance bound)")
    ap.add_argument("--device-trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of one straight "
                         "chunk (phases appear as record_function spans in "
                         "Perfetto); also writes DIR/phases.trace.json host "
                         "spans")
    ap.add_argument("--md", action="store_true",
                    help="print the attribution table as markdown")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu to run on the "
                         "CPU)")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.core.engine import resolve_device

    dev = resolve_device(args.device)
    eng, label = build_engine(args.config, metrics_ring=args.metrics_ring,
                              hosts=args.hosts, device=dev)
    att = attribution(eng, n_windows=args.windows, warmup=args.warmup,
                      reps=args.reps)
    att = {"probe": "phaseprobe", "config": label, "backend": dev.type,
           **att}
    if args.device_trace:
        device_trace_run(eng, args.device_trace, args.windows, args.warmup)
        att["device_trace"] = args.device_trace
    print(_table(label, att, md=args.md), file=sys.stderr, flush=True)
    print(json.dumps(att))
    if args.min_coverage and (att["coverage"] or 0) < args.min_coverage:
        print(f"[phaseprobe] attribution coverage {att['coverage']} below "
              f"{args.min_coverage} — the phase split no longer accounts "
              f"for the window loop", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

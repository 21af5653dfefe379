"""Fleet↔solo digest-parity verifier — the fleet contract, live (port of
``tools/fleetprobe.py``).

    python -m shadow1_tpu_torch.tools.fleetprobe sweep.yaml [--sides tpu,cpu]
        [--windows N] [--exps 0,2] [--device DEV] [--json-only]
    python -m shadow1_tpu_torch.tools.fleetprobe sweep.yaml --retry
        [--sides tpu,cpu] [--windows N] [--chunk C] [--device DEV]

Expands the config's ``sweep:`` section, runs the WHOLE fleet as one
``FleetEngine`` with the determinism flight recorder on, then runs each
experiment ALONE on the requested sides (``tpu`` = the port's solo
``Engine``, ``cpu`` = the eager numpy oracle) and asserts the per-window digest
streams are bit-identical per experiment: lane e of the fleet must be
indistinguishable from running experiment e by itself
(docs/SEMANTICS.md §"Fleet contract").

``--retry`` proves the FLEET TRANSACTIONAL RETRY contract instead
(docs/SEMANTICS.md §"Fleet recovery contract", the solo retry proof's
fleet form): the config must be deliberately under-capped — the sweep runs
under ``--on-overflow retry`` (chunks discarded, the fleet-uniform cap
grown, replayed), must actually retry at least once, and every lane's
committed digest stream must bit-match (a) the straight fleet run at the
final grown caps and (b, ``cpu`` side) the eager oracle at those caps.

The fleet and the solo engines run on the caller's device: CUDA unless
``--device`` names another (``core/engine.py resolve_device``); the
oracle runs on the host.

Exit codes: 0 = parity, 3 = divergence (the last stdout line is a JSON
verdict either way). On a mismatch the verdict names the first divergent
(experiment, side, window, subsystems).
"""

from __future__ import annotations

import argparse
import json
import sys

EXIT_DIVERGED = 3


def _ring_digest_stream(st, window_ns: int) -> dict[int, tuple]:
    from shadow1_tpu_torch.core.digest import SUBSYSTEMS
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    return {
        r["window"]: tuple(r[f"dg_{s}"] for s in SUBSYSTEMS)
        for r in drain_ring(st, window_ns)
        if r["type"] == "ring"
    }


def _first_mismatch(fleet: dict, solo: dict) -> dict | None:
    from shadow1_tpu_torch.core.digest import SUBSYSTEMS

    if sorted(fleet) != sorted(solo):
        return {"window": None,
                "reason": f"window sets differ (fleet {len(fleet)}, "
                          f"solo {len(solo)})"}
    for w in sorted(fleet):
        if fleet[w] != solo[w]:
            subs = [s for s, a, b in
                    zip(SUBSYSTEMS, fleet[w], solo[w]) if a != b]
            return {"window": w, "subsystems": subs}
    return None


def _retry_probe(plan, params, windows: int, chunk: int, sides, say,
                 device) -> dict:
    """The fleet-retry bit-exactness proof: under-capped fleet + retry ==
    straight fleet at the final grown caps, per lane, plus the cpu-oracle
    side at those caps."""
    import dataclasses

    from shadow1_tpu_torch.core.digest import SUBSYSTEMS
    from shadow1_tpu_torch.fleet.engine import FleetEngine, slice_experiment
    from shadow1_tpu_torch.fleet.run import run_fleet

    p_retry = dataclasses.replace(params, on_overflow="retry")
    eng = FleetEngine(plan.exps, p_retry, plan.max_rounds, device=device)
    say(f"[fleetprobe] retry fleet: {eng.n_exp} experiments x {windows} "
        f"windows at ev_cap={p_retry.ev_cap}")
    st, hb = run_fleet(eng, n_windows=windows, every_windows=chunk,
                       stream=False)
    guard = hb.guard
    verdict = {
        "mode": "retry",
        "experiments": eng.n_exp,
        "windows": windows,
        "chunk_retries": guard.chunk_retries,
        "retry_windows_rerun": guard.retry_windows_rerun,
        "final_caps": guard.final_caps,
        "sides": list(sides),
        "mismatches": [],
    }
    if guard.chunk_retries == 0:
        verdict.update(ok=False, error="config never overflowed — the "
                                       "retry proof needs an under-capped "
                                       "sweep (shrink engine.ev_cap)")
        return verdict
    retry_streams = [
        _ring_digest_stream(slice_experiment(st, e, eng.n_exp), eng.window)
        for e in range(eng.n_exp)
    ]
    p_big = dataclasses.replace(
        params, on_overflow="drop",
        ev_cap=guard.final_caps["ev_cap"],
        outbox_cap=guard.final_caps["outbox_cap"])
    if "tpu" in sides:
        big = FleetEngine(plan.exps, p_big, plan.max_rounds, device=device)
        st_big = big.run(n_windows=windows)
        for e in range(eng.n_exp):
            solo = _ring_digest_stream(slice_experiment(st_big, e, big.n_exp),
                                       big.window)
            mm = _first_mismatch(retry_streams[e], solo)
            if mm is None:
                say(f"[fleetprobe] exp {e} retry vs big-cap fleet: "
                    f"{len(solo)} windows bit-identical")
            else:
                verdict["mismatches"].append(
                    {"exp": e, "side": "tpu", **mm})
    if "cpu" in sides:
        from shadow1_tpu_torch.cpu_engine import CpuEngine

        for e, exp in enumerate(plan.exps):
            cpu = CpuEngine(exp, dataclasses.replace(
                p_big, max_rounds=plan.max_rounds[e]))
            cpu.run(n_windows=windows)
            orc = {r["window"]: tuple(r[f"dg_{s}"] for s in SUBSYSTEMS)
                   for r in cpu.digest_rows}
            sub = {w: retry_streams[e][w] for w in orc
                   if w in retry_streams[e]}
            if orc == sub and len(orc) == len(retry_streams[e]):
                say(f"[fleetprobe] exp {e} retry vs cpu oracle at final "
                    f"caps: {len(orc)} windows bit-identical")
            else:
                mm = _first_mismatch(retry_streams[e], orc)
                verdict["mismatches"].append(
                    {"exp": e, "side": "cpu", **(mm or {})})
    verdict["ok"] = not verdict["mismatches"]
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.fleetprobe")
    ap.add_argument("config", help="YAML experiment file with a sweep: "
                                   "section")
    ap.add_argument("--sides", default="tpu,cpu",
                    help="comma list of solo sides to compare each fleet "
                         "lane against: tpu (solo batched engine), cpu "
                         "(eager oracle). Default both.")
    ap.add_argument("--windows", type=int, default=None,
                    help="compare only this many windows (default: the "
                         "configured run, capped at 200)")
    ap.add_argument("--exps", default=None,
                    help="comma list of experiment indices to solo-check "
                         "(default: all)")
    ap.add_argument("--retry", action="store_true",
                    help="fleet transactional-retry proof: run the "
                         "(deliberately under-capped) sweep under "
                         "--on-overflow retry and assert per-lane digest "
                         "parity with the straight big-cap fleet run "
                         "(tpu side) and the eager oracle (cpu side)")
    ap.add_argument("--chunk", type=int, default=5,
                    help="chunk (windows) for the --retry transactional "
                         "boundaries")
    ap.add_argument("--device", default=None,
                    help="torch device of the fleet and the solo engines "
                         "(default: cuda; cpu to run on the CPU)")
    ap.add_argument("--json-only", action="store_true",
                    help="suppress progress lines; print only the verdict")
    args = ap.parse_args(argv)

    import dataclasses

    from shadow1_tpu_torch.core.engine import resolve_device
    from shadow1_tpu_torch.fleet.expand import FleetConfigError, load_sweep
    from shadow1_tpu_torch.obs import build_kernels

    device = resolve_device(args.device)
    build_kernels(device)

    def config_exit(e: FleetConfigError) -> int:
        print(f"fleetprobe: {e}", file=sys.stderr)
        print(json.dumps({"ok": False, "error": "fleet_config",
                          "kind": e.kind, "knob": e.knob,
                          "message": str(e)}))
        return 2

    try:
        plan = load_sweep(args.config)
    except FleetConfigError as e:
        return config_exit(e)
    windows = args.windows
    sides = [s.strip() for s in args.sides.split(",") if s.strip()]

    def say(msg):
        if not args.json_only:
            print(msg, file=sys.stderr, flush=True)

    from shadow1_tpu_torch.core.digest import SUBSYSTEMS
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.fleet.engine import FleetEngine, slice_experiment

    # Digest transport: a ring deep enough to hold the whole compared run.
    n_total = int(-(-plan.exps[0].end_time // plan.exps[0].window))
    if windows is None:
        windows = min(n_total, 200)
    params = dataclasses.replace(plan.params, state_digest=1,
                                 metrics_ring=max(windows, 1))

    if args.retry:
        verdict = _retry_probe(plan, params, windows, args.chunk, sides,
                               say, device)
        print(json.dumps(verdict))
        if verdict.get("error"):
            return 2
        return 0 if verdict["ok"] else EXIT_DIVERGED

    try:
        fleet = FleetEngine(plan.exps, params, plan.max_rounds, device=device)
    except FleetConfigError as e:
        # Mode rejections raised at engine construction (auto_caps /
        # on_overflow=retry in the config's engine: section) keep the
        # same "last stdout line is a JSON verdict" contract.
        return config_exit(e)
    say(f"[fleetprobe] fleet: {fleet.n_exp} experiments x {windows} "
        f"windows, {fleet.exp.n_hosts} hosts, on {device}")
    stf = fleet.run(n_windows=windows)
    fleet_streams = [
        _ring_digest_stream(slice_experiment(stf, e, fleet.n_exp),
                            fleet.window)
        for e in range(fleet.n_exp)
    ]

    exp_ids = (range(fleet.n_exp) if args.exps is None
               else [int(x) for x in args.exps.split(",")])
    compared = {s: 0 for s in sides}
    mismatches = []
    for e in exp_ids:
        exp = plan.exps[e]
        p_e = dataclasses.replace(params, max_rounds=plan.max_rounds[e])
        for side in sides:
            if side == "tpu":
                eng = Engine(exp, p_e, device=device)
                solo = _ring_digest_stream(eng.run(n_windows=windows),
                                           eng.window)
            elif side == "cpu":
                from shadow1_tpu_torch.cpu_engine import CpuEngine

                cpu = CpuEngine(exp, p_e)
                cpu.run(n_windows=windows)
                solo = {
                    r["window"]: tuple(r[f"dg_{s}"] for s in SUBSYSTEMS)
                    for r in cpu.digest_rows
                }
            else:
                raise SystemExit(f"unknown side {side!r} (tpu|cpu)")
            mm = _first_mismatch(fleet_streams[e], solo)
            if mm is None:
                compared[side] += 1
                say(f"[fleetprobe] exp {e} vs solo {side}: "
                    f"{len(solo)} windows bit-identical")
            else:
                mismatches.append({"exp": e, "side": side, **mm})
                say(f"[fleetprobe] exp {e} vs solo {side}: DIVERGED {mm}")

    verdict = {
        "ok": not mismatches,
        "experiments": fleet.n_exp,
        "solo_checked": list(exp_ids),
        "windows": windows,
        "sides": sides,
        "streams_compared": compared,
        "mismatches": mismatches,
    }
    print(json.dumps(verdict))
    return 0 if not mismatches else EXIT_DIVERGED


if __name__ == "__main__":
    raise SystemExit(main())

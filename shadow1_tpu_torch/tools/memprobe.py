"""Memory-plane verifier — estimator audit, feasibility search, sub-batch
parity proof (port of ``tools/memprobe.py``; the memory model is the
port's own, ``mem.py``).

    python -m shadow1_tpu_torch.tools.memprobe CONFIG [CONFIG ...] --audit
    python -m shadow1_tpu_torch.tools.memprobe CONFIG --maxfit [--budget BYTES]
    python -m shadow1_tpu_torch.tools.memprobe SWEEP --subbatch [--sub K]

Every mode runs on CUDA unless ``--device cpu`` is given (with no card
and no ``--device cpu`` it exits non-zero). Configs are YAML or JSON (the
card has no YAML parser: pass JSON there). Three modes (combinable;
default ``--audit``):

* ``--audit`` — estimator-vs-actual byte audit: for each config, the
  pre-flight estimate, then the engine and its state BUILT for real and
  measured: on the card the ``torch.cuda.memory_allocated`` delta of the
  build, on the CPU ``mem.live_bytes`` of the ctx tables and the state.
  The resident estimate must be within ``mem.AUDIT_TOLERANCE`` (10 %) of
  the measured bytes. One row per config; exit 1 when any row is out of
  tolerance.
* ``--maxfit`` — the feasible envelope at the budget (``--budget``, else
  ``SHADOW1_MEM_BYTES``, else ``mem.device_budget`` of the card): the most
  hosts at this config's shape class (the estimate scales with H), and for
  a config with a ``sweep:`` the most lanes that fit (``mem.max_lanes``,
  at most the sweep's E) and the per-lane linear envelope beyond it.
  Estimator-only: nothing is allocated on the card.
* ``--subbatch`` — the downshift bit-exactness proof: the sweep as ONE
  full-E fleet with the digest words on, then as sequential sub-batches of
  ``--sub`` lanes (default ceil(E/2)), each THROUGH a mid-batch snapshot
  (``ckpt.save_state`` at the halfway window, reload into a fresh engine
  with ``ckpt.load_fleet_state``, continue). Every lane's per-window digest
  stream AND parity metrics must be bit-identical. Exit 3 on divergence;
  the verdict names the first divergent (exp, window).

The last stdout line is always one JSON verdict.
"""

from __future__ import annotations

import argparse
import json
import sys

EXIT_DIVERGED = 3
EXIT_AUDIT_FAILED = 1


def _parity_counter_names():
    from shadow1_tpu_torch.telemetry.registry import METRIC_SPECS, gauge_names

    # Per-lane parity comparands: every canonical counter that is not a
    # batch-engine-only occupancy artifact (rounds/fires depend on the
    # batch's shape and are excluded from cross-run parity everywhere).
    skip = set(gauge_names()) | {"rounds", "round_cap_hits"}
    skip |= {n for n in METRIC_SPECS if n.startswith("fires_")}
    return [n for n in METRIC_SPECS if n not in skip]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def audit_config(path: str, fleet: bool = False, device=None) -> dict:
    """One estimator-vs-actual row of the config at ``path`` (its sweep as
    a fleet with ``fleet``)."""
    if fleet:
        from shadow1_tpu_torch.fleet.expand import load_sweep

        plan = load_sweep(path)
        return audit_experiment(path, plan.exps[0], plan.params,
                                (plan.exps, plan.max_rounds), device)
    from shadow1_tpu_torch.config.experiment import load_experiment

    exp, params, _ = load_experiment(path)
    return audit_experiment(path, exp, params, None, device)


def audit_experiment(label: str, exp, params, fleet=None,
                     device=None) -> dict:
    """One estimator-vs-actual row: build the engine (a FleetEngine of
    ``fleet`` = (experiments, max_rounds)) and its state for real and
    compare the measured bytes with the resident estimate."""
    import gc

    import torch

    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.core.engine import resolve_device

    dev = resolve_device(device)
    est = mem.estimate(exp, params, fleet)
    n_exp = len(fleet[0]) if fleet is not None else 1
    gc.collect()
    base = 0
    if dev.type == "cuda":
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
    if fleet is not None:
        from shadow1_tpu_torch.fleet.engine import FleetEngine

        eng = FleetEngine(fleet[0], params, fleet[1], device=dev)
    else:
        from shadow1_tpu_torch.core.engine import Engine

        eng = Engine(exp, params, device=dev)
    st = eng.init_state()
    _sync(dev)
    measured = mem.live_bytes(eng.ctx, st) - base
    del st, eng
    gc.collect()
    ratio = est.resident_bytes / measured if measured else float("inf")
    return {
        "config": label,
        "n_exp": n_exp,
        "device": dev.type,
        "estimated_state": est.state_bytes,
        "estimated_resident": est.resident_bytes,
        "estimated_peak": est.peak_bytes,
        "measured_live": int(measured),
        "ratio": round(ratio, 4),
        "ok": bool(abs(ratio - 1.0) <= mem.AUDIT_TOLERANCE),
    }


def maxfit(path: str, budget: int) -> dict:
    """The feasible envelope of the config at ``path`` at ``budget`` (its
    sweep's lanes too, when it has a ``sweep:``)."""
    from shadow1_tpu_torch.config.experiment import load_experiment

    exp, params, _ = load_experiment(path)
    try:
        from shadow1_tpu_torch.fleet.expand import load_sweep

        plan = load_sweep(path)
    except Exception:  # noqa: BLE001 — no sweep: section, solo config
        plan = None
    return maxfit_experiment(path, exp, params, budget, plan)


def maxfit_experiment(label: str, exp, params, budget: int,
                      plan=None) -> dict:
    """The feasible envelope at ``budget`` — estimator-only (every estimate
    is built on the meta device, or on the host when small), so nothing is
    allocated on the card."""
    from shadow1_tpu_torch import mem

    # ONE real estimate; the search is arithmetic: every state plane is
    # [.., H], so the peak scales ~H (the const tables too).
    base = mem.estimate(exp, params)
    per_host = base.peak_bytes / max(exp.n_hosts, 1)

    def fits_h(h: int) -> bool:
        return per_host * h <= budget

    if not fits_h(1):
        lo = 0   # not even one host fits: an honest infeasible verdict
    else:
        lo, hi = 1, exp.n_hosts
        while fits_h(hi) and hi < (1 << 24):
            lo, hi = hi, hi * 2
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if fits_h(mid):
                lo = mid
            else:
                hi = mid
    out = {"config": label, "budget": int(budget), "hosts": exp.n_hosts,
           "estimated_peak": base.peak_bytes, "max_hosts": int(lo)}
    if plan is not None:
        fleet = (plan.exps, plan.max_rounds)
        n = len(plan.exps)
        out["sweep_lanes"] = n
        out["max_lanes"] = int(mem.max_lanes(plan.exps[0], plan.params,
                                             fleet, budget))
        # Beyond the sweep: the per-lane bytes from the full and the
        # one-lane estimates, extrapolated linearly (the reference's
        # ``MemEstimate.max_lanes`` arithmetic).
        full = mem.estimate(plan.exps[0], plan.params, fleet).peak_bytes
        one = mem.estimate(plan.exps[0], plan.params,
                           (plan.exps[:1], plan.max_rounds[:1])).peak_bytes
        lane = (full - one) / (n - 1) if n > 1 else one
        fixed = one - lane
        out["lane_bytes"] = int(lane)
        out["max_lanes_linear"] = (int(max(budget - fixed, 0) // lane)
                                   if lane > 0 else n)
    return out


def _lane_streams(eng, st) -> dict[int, dict[int, tuple]]:
    """Per-lane {window: digest words} from a fleet state's rings."""
    from shadow1_tpu_torch.telemetry.registry import RING_DIGESTS

    streams: dict[int, dict[int, tuple]] = {}
    for r in eng.drain_rings(st):
        if r["type"] != "ring":
            continue
        streams.setdefault(r["exp"], {})[r["window"]] = tuple(
            r[f] for f in RING_DIGESTS)
    return streams


def subbatch_run(path: str, sub: int | None, windows: int | None, say,
                 device=None) -> tuple[dict, dict]:
    """Full-E fleet vs sequential sub-batches (each cycled through a
    mid-batch snapshot and reload): (verdict, the full fleet's per-lane
    digest streams)."""
    import dataclasses
    import os
    import tempfile

    from shadow1_tpu_torch.ckpt import load_fleet_state, save_state
    from shadow1_tpu_torch.convert import fleet_to_saved
    from shadow1_tpu_torch.core.engine import resolve_device
    from shadow1_tpu_torch.fleet.engine import FleetEngine
    from shadow1_tpu_torch.fleet.expand import load_sweep

    dev = resolve_device(device)
    plan = load_sweep(path)
    E = len(plan.exps)
    sub = sub or -(-E // 2)
    n_windows = windows
    if n_windows is None:
        n_windows = min(int(-(-plan.exps[0].end_time
                              // plan.exps[0].window)), 100)
    # Ring depth covers the compared horizon, so both sides drain the same
    # gap-free window set.
    params = dataclasses.replace(
        plan.params, state_digest=1,
        metrics_ring=max(plan.params.metrics_ring, 64, n_windows))
    say(f"full fleet: {E} lanes x {n_windows} windows")
    eng_full = FleetEngine(plan.exps, params, plan.max_rounds, device=dev)
    st_full = eng_full.run(n_windows=n_windows)
    full_streams = _lane_streams(eng_full, st_full)
    full_metrics = eng_full.metrics_per_exp(st_full)
    del st_full, eng_full
    counters = _parity_counter_names()
    sub_streams: dict[int, dict[int, tuple]] = {}
    sub_metrics: dict[int, dict] = {}
    half = n_windows // 2
    with tempfile.TemporaryDirectory(prefix="memprobe_") as ck_dir:
        ck = os.path.join(ck_dir, "batch.npz")
        for i in range(0, E, sub):
            exps, mr = plan.exps[i:i + sub], plan.max_rounds[i:i + sub]
            say(f"sub-batch lanes [{i}, {i + len(exps)}) (snapshot cycle "
                f"at window {half})")

            def engine():
                eng = FleetEngine(exps, params, mr, device=dev)
                eng.exp_base = i
                return eng

            eng_b = engine()
            if half > 0:
                # The per-sub-batch resume path of --on-oom downshift with
                # --ckpt: snapshot, reload into a FRESH engine, continue.
                save_state(fleet_to_saved(eng_b.run(n_windows=half),
                                          eng_b.n_exp), ck)
                eng_b = engine()
                st_b = eng_b.run(load_fleet_state(eng_b.init_state(), ck,
                                                  eng_b.n_exp),
                                 n_windows=n_windows - half)
            else:
                st_b = eng_b.run(n_windows=n_windows)
            sub_streams.update(_lane_streams(eng_b, st_b))
            for j, m in enumerate(eng_b.metrics_per_exp(st_b)):
                sub_metrics[i + j] = m
    verdict = {"config": path, "experiments": E, "lanes_per_batch": sub,
               "windows": n_windows, "ckpt_cycled": half > 0,
               "streams_compared": len(full_streams), "device": dev.type}
    for e in range(E):
        f, s = full_streams.get(e, {}), sub_streams.get(e, {})
        if f != s:
            bad = next((w for w in sorted(f) if f.get(w) != s.get(w)),
                       None)
            verdict.update(
                ok=False, diverged={"exp": e, "window": bad,
                                    "kind": "digest_stream"},
                hint=f"bisect lane {e} solo: python -m shadow1_tpu_torch."
                     f"tools.paritytrace {path} tpu cpu")
            return verdict, full_streams
        fm = {k: full_metrics[e].get(k, 0) for k in counters}
        sm = {k: sub_metrics[e].get(k, 0) for k in counters}
        if fm != sm:
            diff = {k: [fm[k], sm[k]] for k in counters if fm[k] != sm[k]}
            verdict.update(ok=False,
                           diverged={"exp": e, "kind": "metrics",
                                     "fields": diff})
            return verdict, full_streams
    verdict["ok"] = True
    return verdict, full_streams


def subbatch_parity(path: str, sub: int | None, windows: int | None,
                    say, device=None) -> dict:
    """The ``--subbatch`` verdict (see :func:`subbatch_run`)."""
    return subbatch_run(path, sub, windows, say, device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.memprobe")
    ap.add_argument("configs", nargs="+",
                    help="experiment file(s), YAML or JSON")
    ap.add_argument("--audit", action="store_true",
                    help="estimator-vs-live-bytes audit (default mode)")
    ap.add_argument("--fleet", action="store_true",
                    help="audit the config's sweep: as a fleet state")
    ap.add_argument("--maxfit", action="store_true",
                    help="search the most hosts/lanes that fit")
    ap.add_argument("--subbatch", action="store_true",
                    help="sub-batched-fleet == full-fleet parity proof")
    ap.add_argument("--sub", type=int, default=None,
                    help="lanes per sub-batch (default ceil(E/2))")
    ap.add_argument("--windows", type=int, default=None,
                    help="windows for the --subbatch comparison")
    ap.add_argument("--budget", type=int, default=None,
                    help="byte budget for --maxfit (default: "
                         "SHADOW1_MEM_BYTES, else the card's)")
    ap.add_argument("--device", default=None,
                    help="CUDA device (default: cuda, which must be "
                         "present) or cpu")
    ap.add_argument("--json-only", action="store_true",
                    help="suppress progress lines; print only the verdict")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.core.engine import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"memprobe: {e}", file=sys.stderr)
        print(json.dumps({"ok": False, "error": "no_device",
                          "message": str(e)}))
        return 2

    def say(msg):
        if not args.json_only:
            print(f"[memprobe] {msg}", file=sys.stderr, flush=True)

    if not (args.audit or args.maxfit or args.subbatch):
        args.audit = True
    rc = 0
    out: dict = {"ok": True, "device": str(dev)}
    if args.audit:
        rows = []
        for cfg in args.configs:
            say(f"audit {cfg}")
            row = audit_config(cfg, fleet=args.fleet, device=dev)
            say(f"  estimated {mem.fmt_bytes(row['estimated_resident'])} "
                f"vs measured {mem.fmt_bytes(row['measured_live'])} "
                f"(ratio {row['ratio']}) "
                f"{'ok' if row['ok'] else 'OUT OF TOLERANCE'}")
            rows.append(row)
        out["audit"] = rows
        if not all(r["ok"] for r in rows):
            out["ok"] = False
            rc = EXIT_AUDIT_FAILED
    if args.maxfit:
        budget, src = args.budget, "--budget"
        if budget is None:
            budget, src = mem.device_budget(dev)
            if budget is None:
                print("memprobe: no budget (the CPU reports none; pass "
                      "--budget or set SHADOW1_MEM_BYTES)", file=sys.stderr)
                print(json.dumps({"ok": False, "error": "no_budget"}))
                return 2
        out["budget_source"] = src
        out["maxfit"] = [maxfit(cfg, budget) for cfg in args.configs]
    if args.subbatch:
        v = subbatch_parity(args.configs[0], args.sub, args.windows, say,
                            device=dev)
        out["subbatch"] = v
        if not v["ok"]:
            out["ok"] = False
            rc = EXIT_DIVERGED
    print(json.dumps(out))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

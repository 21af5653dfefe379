"""Event-buffer occupancy audit — size ev_cap from measurement, not guess
(port of ``tools/occprobe.py``).

    python -m shadow1_tpu_torch.tools.occprobe [--windows N] [--step S]
        [--device DEV] config.yaml [config.yaml ...]

Every pop/push/rebase is a full [ev_cap, H] plane pass, so ev_cap is the
plane height of the hottest tensors in the round; a cap sized far above
the workload's real peak occupancy taxes every round for headroom it never
uses. This tool runs a config in --step-window chunks and reports the peak
per-host event-slot occupancy OBSERVED AT CHUNK BOUNDARIES — a LOWER BOUND
on the true peak (occupancy peaks mid-window, while delivered packets
coexist with freshly pushed events, and the snapshot sees only the
leftovers). Size caps as boundary-peak + generous margin and treat a cap
change as validated only by an overflow-free full run: ev_overflow (in
every measurement row) is the authoritative guard, and this tool exits
nonzero when the audited run itself overflowed (the reported peak is then
meaningless — events that were dropped never occupied a slot).

It runs the port's ``Engine`` on the caller's device: CUDA unless
``--device`` names another (``core/engine.py resolve_device``; with no
card and no ``--device cpu`` it exits non-zero). Occupancy is
device-invariant (the engines are bit-identical), so the row is the same
on either.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.occprobe")
    ap.add_argument("configs", nargs="+")
    ap.add_argument("--windows", type=int, default=0,
                    help="windows to audit (0 = the config's full run)")
    ap.add_argument("--step", type=int, default=10,
                    help="windows per engine call between readbacks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu to run on the "
                         "CPU)")
    args = ap.parse_args(argv)
    if args.step < 1:
        ap.error("--step must be >= 1")
    if args.windows < 0:
        ap.error("--windows must be >= 0")

    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.core.engine import Engine, resolve_device
    from shadow1_tpu_torch.obs import build_kernels

    device = resolve_device(args.device)
    build_kernels(device)
    bad = False
    for cfg in args.configs:
        exp, params, _ = load_experiment(cfg)
        eng = Engine(exp, params, device=device)
        nw = args.windows or eng.n_windows
        st = eng.init_state()
        # Count the seeded initial state too — a model that seeds a burst
        # draining inside the first chunk would otherwise be missed.
        peak = int((st.evbuf.kind != 0).sum(dim=0).max())
        done = 0
        while done < nw:
            step = min(args.step, nw - done)
            st = eng.run(st, n_windows=step)
            done += step
            peak = max(peak, int((st.evbuf.kind != 0).sum(dim=0).max()))
        m = Engine.metrics_dict(st)
        row = {
            "config": cfg, "windows": done, "ev_cap": params.ev_cap,
            "boundary_peak_occupancy": peak,
            "ev_overflow": int(m["ev_overflow"]),
            "headroom": round(params.ev_cap / max(peak, 1), 2),
        }
        if row["ev_overflow"]:
            row["invalid"] = ("run overflowed — dropped events never "
                              "occupied a slot; the peak is meaningless")
            bad = True
        print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())

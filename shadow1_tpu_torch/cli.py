"""Command line: run one YAML experiment on the port.

    python -m shadow1_tpu_torch CFG.yaml [--device cuda|cpu] [--windows N]
        [--metrics-ring W] [--state-digest on|off]

Prints one JSON line: ``{"metrics": {...}, "summary": {...}, "device":
...}`` plus the run's shape and wall time. ``metrics`` has the keys of the
reference's ``Engine.metrics_dict``; ``summary`` the model's scalar totals.
With a telemetry ring (``--metrics-ring W``, or ``engine.metrics_ring`` in
the config; ``--state-digest on`` sets a 64-window ring when there is
none) the run goes in chunks of W windows and prints each window's ring
row (``telemetry/ring.py drain_ring``: counter deltas, gauges and the
state-digest words) as one JSON line before the result line. The run is
on CUDA unless ``--device cpu`` is given; with no card it fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m shadow1_tpu_torch",
        description="Run a shadow1_tpu YAML experiment on the PyTorch port.")
    ap.add_argument("config", help="YAML experiment file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--windows", type=int, default=None,
                    help="windows to run (default: to the config's stop_time)")
    ap.add_argument("--metrics-ring", type=int, default=None, metavar="W",
                    help="keep a W-window on-device telemetry ring and print "
                         "one JSON line per window (overrides "
                         "engine.metrics_ring from the config)")
    ap.add_argument("--state-digest", choices=["on", "off"], default=None,
                    metavar="on|off",
                    help="per-window order-independent state digests "
                         "(evbuf/outbox/tcp/nic/rng words) as ring columns; "
                         "a 64-window ring is set when there is none "
                         "(overrides engine.state_digest)")
    args = ap.parse_args(argv)

    import torch

    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    exp, params, scheduler = load_experiment(args.config)
    if scheduler == "sharded":
        raise NotImplementedError(
            "scheduler: sharded is not ported yet (ROADMAP: fleet, shard, serve)")
    if args.metrics_ring is not None:
        params = dataclasses.replace(params, metrics_ring=args.metrics_ring)
    if args.state_digest is not None:
        params = dataclasses.replace(
            params, state_digest=int(args.state_digest == "on"))
    if (params.state_digest and params.metrics_ring <= 0
            and args.metrics_ring is None):
        params = dataclasses.replace(params, metrics_ring=64)
    eng = Engine(exp, params, device=args.device)
    n = args.windows if args.windows is not None else eng.n_windows
    ring = params.metrics_ring
    t0 = time.perf_counter()
    st, done = None, 0
    while done < n or st is None:
        step = min(n - done, ring) if ring > 0 else n - done
        st = eng.run(st, n_windows=step)
        for rec in drain_ring(st, eng.window, start=done):
            print(json.dumps(rec), flush=True)
        done += step
    metrics = Engine.metrics_dict(st)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    summary = {k: int(v) for k, v in eng.model_summary(st).items()
               if getattr(v, "ndim", 0) == 0}
    device = (torch.cuda.get_device_name(eng.device)
              if eng.device.type == "cuda" else "cpu")
    print(json.dumps({
        "metrics": metrics,
        "summary": summary,
        "device": device,
        "hosts": exp.n_hosts,
        "windows": metrics["windows"],
        "wall_seconds": wall,
        "events_per_sec": metrics["events"] / wall if wall > 0 else None,
    }))
    return 0

"""Command line: run one YAML experiment on the port.

    python -m shadow1_tpu_torch CFG.yaml [--device cuda|cpu] [--windows N]

Prints one JSON line: ``{"metrics": {...}, "summary": {...}, "device":
...}`` plus the run's shape and wall time. ``metrics`` has the keys of the
reference's ``Engine.metrics_dict``; ``summary`` the model's scalar totals.
The run is on CUDA unless ``--device cpu`` is given; with no card it
fails.
"""

from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)

    import torch

    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.core.engine import Engine

    exp, params, scheduler = load_experiment(args.config)
    if scheduler == "sharded":
        raise NotImplementedError(
            "scheduler: sharded is not ported yet (ROADMAP: fleet, shard, serve)")
    eng = Engine(exp, params, device=args.device)
    t0 = time.perf_counter()
    st = eng.run(n_windows=args.windows)
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

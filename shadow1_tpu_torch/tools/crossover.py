"""The dense-scale crossover sweep: the batched engine on the card against
the port's C++ thread-per-core comparator, by host count (port of
``tools/crossover.py``).

    python -m shadow1_tpu_torch.tools.crossover [--hosts 2000,5000,...]
        [--windows N] [--cpp-windows N] [--json PATH] [--device cpu]

An eager per-event engine pays per event; the batched engine pays per
round, and its fixed round cost amortizes as the mesh grows. This tool
measures both on one workload — the dense tgen mesh of
``configs/dense_tgen50k.yaml`` scaled to each host count (``dense_doc``,
the same document built in code, so no YAML parser is needed) — and
prints one JSON row per size:

    {"n_hosts": N, "events_per_sec": ..., "cpp_events_per_sec": ...,
     "tpu_vs_cpp": ...}

Each batched run executes in a child process (a fresh CUDA context and
kernel build per size), timed over chunked 10-window runs after a
one-window warm-up (the kernel build and the first launches); the
comparator (``native/``) runs the same config for ``--cpp-windows``
windows. Where both sides run the same windows the event counters must
match (the parity contract); otherwise the row records both counts. The
batched side runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

DEFAULT_HOSTS = (2000, 5000, 10000, 20000, 50000)
CHUNK = 10

# configs/dense_tgen50k.yaml as a document (``config/experiment.
# build_experiment``'s input); tests hold the two equal.
DENSE_DOC = {
    "general": {"seed": 71, "stop_time": "20 s"},
    "engine": {"scheduler": "tpu", "ev_cap": 96, "outbox_cap": 32,
               "sockets_per_host": 8, "msgq_cap": 4, "max_rounds": 512,
               "rcvbuf": 16384},
    "network": {"single_vertex": {"latency": "10 ms"}},
    "hosts": [{"name": "node", "count": 50000, "bandwidth_up": "20 Mbit",
               "bandwidth_down": "20 Mbit"}],
    "app": {
        "model": "tgen",
        "params": {"fixed_size": True},
        "defaults": {"start_time": "10 ms"},
        "groups": {"node": {"active": 1, "streams": 1000000,
                            "mean_bytes": 30000000,
                            "mean_think_ns": "50 ms"}},
    },
}


def dense_doc(n_hosts: int) -> dict:
    """``configs/dense_tgen50k.yaml`` scaled to ``n_hosts`` (the same
    per-host parameters; only the count changes)."""
    doc = copy.deepcopy(DENSE_DOC)
    doc["hosts"][0]["count"] = n_hosts
    return doc


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def child_main(n_hosts: int, windows: int, device=None) -> int:
    from shadow1_tpu_torch.config.experiment import build_experiment
    from shadow1_tpu_torch.core.engine import Engine, resolve_device
    from shadow1_tpu_torch.obs import build_kernels

    dev = resolve_device(device)
    exp, params, _ = build_experiment(dense_doc(n_hosts))
    t0 = time.perf_counter()
    build_kernels(dev)
    eng = Engine(exp, params, device=dev)
    eng.run(eng.init_state(), n_windows=1)
    _sync(dev)
    warm_s = time.perf_counter() - t0

    st = eng.init_state()
    done = 0
    t0 = time.perf_counter()
    while done < windows:
        step = min(CHUNK, windows - done)
        st = eng.run(st, n_windows=step)
        done += step
    _sync(dev)
    wall = time.perf_counter() - t0
    m = Engine.metrics_dict(st)
    print(json.dumps({
        "device": (__import__("torch").cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"),
        "n_hosts": n_hosts,
        "windows": windows,
        "events": m["events"],
        "wall_s": round(wall, 3),
        "warmup_s": round(warm_s, 2),
        "events_per_sec": round(m["events"] / wall, 1) if wall else None,
        "rounds_per_window": round(m["rounds"] / max(m["windows"], 1), 1),
        "ev_overflow": m["ev_overflow"],
        "ob_overflow": m["ob_overflow"],
    }))
    return 0


def run_cpp(n_hosts: int, windows: int) -> dict:
    from shadow1_tpu_torch import native
    from shadow1_tpu_torch.config.experiment import build_experiment

    exp, params, _ = build_experiment(dense_doc(n_hosts))
    try:
        r = native.run_net(exp, params, windows,
                           n_threads=os.cpu_count() or 1)
    except Exception as e:  # noqa: BLE001 — no toolchain -> no baseline
        return {"cpp_error": repr(e)[:300]}
    return {
        "cpp_windows": windows,
        "cpp_events": r["events"],
        "cpp_wall_s": round(r["wall_s"], 3),
        "cpp_events_per_sec": r["events_per_sec"],
        "cpp_threads": r["n_threads"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.crossover")
    ap.add_argument("--hosts", default=",".join(map(str, DEFAULT_HOSTS)))
    ap.add_argument("--windows", type=int, default=60,
                    help="batched-engine slice (windows)")
    ap.add_argument("--cpp-windows", type=int, default=None,
                    help="C++ slice (default: same as --windows; shrink at "
                         "large sizes where the eager side crawls)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--skip-tpu", action="store_true",
                    help="only measure the C++ side")
    ap.add_argument("--device", default=None,
                    help="the batched side's device (default: cuda)")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        return child_main(args.child, args.windows, args.device)

    rows = []
    for n in (int(x) for x in args.hosts.split(",")):
        row = {"n_hosts": n}
        if not args.skip_tpu:
            cmd = [sys.executable, "-m", "shadow1_tpu_torch.tools.crossover",
                   "--child", str(n), "--windows", str(args.windows)]
            if args.device:
                cmd += ["--device", args.device]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=1800)
                row.update(json.loads(r.stdout.strip().splitlines()[-1]))
            except subprocess.TimeoutExpired:
                row["tpu_error"] = "child exceeded 1800s"
            except (IndexError, ValueError):
                row["tpu_error"] = (r.stderr[-300:] or f"rc={r.returncode}")
        row.update(run_cpp(n, args.cpp_windows or args.windows))
        if row.get("events_per_sec") and row.get("cpp_events_per_sec"):
            row["tpu_vs_cpp"] = round(
                row["events_per_sec"] / row["cpp_events_per_sec"], 3)
            if row.get("windows") == row.get("cpp_windows"):
                row["events_match"] = row["events"] == row["cpp_events"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

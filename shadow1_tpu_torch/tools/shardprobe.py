"""Sharding performance probes: the exchange's fixed price and the scaling
shape (port of ``tools/shardprobe.py``).

    python -m shadow1_tpu_torch.tools.shardprobe overhead [--config PATH]
        [--windows N] [--device cpu]
    python -m shadow1_tpu_torch.tools.shardprobe scale [--devices 1,2,4,8]
        [--windows N] [--json PATH]

* ``overhead`` — one experiment, the solo ``Engine`` against a ONE-RANK
  ``ShardedEngine`` (a world of one in this process: NCCL on the card,
  gloo on the CPU). The difference is the price of the sharded window
  (the bucketed all_to_all with no traffic between ranks, the per-window
  reductions) — the fixed cost that sharding must amortize.
* ``scale`` — the sharded engine on 1, 2, 4 and 8 gloo CPU ranks, each
  rank count in a fresh launch (``shard/launch.py``). CPU walls say
  nothing about the card's, but the SHAPE (how throughput moves as the
  same work spreads over more ranks, exchange included) is a scaling
  datum that needs no second card.

Workloads: the rung-3 Tor net (sparse rounds, the hard case) and the dense
tgen mesh at 2k hosts (``tools/crossover.dense_doc``). A config given as
JSON needs no YAML parser (the card machine's case).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

TOR_CFG = "configs/rung3_tor1k.yaml"


def _dense_exp(n_hosts: int = 2000):
    from shadow1_tpu_torch.config.experiment import build_experiment
    from shadow1_tpu_torch.tools.crossover import dense_doc

    return build_experiment(dense_doc(n_hosts))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_run(eng, windows: int, chunk: int):
    """(warmup_s, wall_s, metrics): a one-window warm-up (the kernel build
    and first launches) excluded."""
    t0 = time.perf_counter()
    eng.run(eng.init_state(), n_windows=1)
    _sync(eng.device)
    warm = time.perf_counter() - t0
    st = eng.init_state()
    done = 0
    t0 = time.perf_counter()
    while done < windows:
        step = min(chunk, windows - done)
        st = eng.run(st, n_windows=step)
        done += step
    _sync(eng.device)
    wall = time.perf_counter() - t0
    return warm, wall, type(eng).metrics_dict(st)


def _row(warm, wall, m) -> dict:
    return {"warmup_s": round(warm, 2), "wall_s": round(wall, 3),
            "events": m["events"], "rounds": m["rounds"],
            "events_per_sec": round(m["events"] / wall, 1) if wall else None}


def overhead_main(config: str, windows: int, device=None) -> int:
    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.core.engine import Engine, resolve_device
    from shadow1_tpu_torch.obs import build_kernels
    from shadow1_tpu_torch.shard.engine import ShardedEngine
    from shadow1_tpu_torch.shard.launch import RankGroup

    dev = resolve_device(device)
    build_kernels(dev)
    exp, params, _ = load_experiment(config)
    out = {"mode": "overhead", "config": config, "windows": windows,
           "device": (__import__("torch").cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    out["plain"] = _row(*_timed_run(Engine(exp, params, device=dev),
                                    windows, chunk=20))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with RankGroup(1, backend, str(dev)):
        warm, wall, m = _timed_run(ShardedEngine(exp, params, device=dev),
                                   windows, chunk=20)
    out["rank1"] = _row(warm, wall, m)
    out["x2x_max_fill"] = m["x2x_max_fill"]
    if out["plain"]["wall_s"] and out["rank1"]["wall_s"]:
        out["rank1_over_plain_wall"] = round(
            out["rank1"]["wall_s"] / out["plain"]["wall_s"], 3)
        # Same experiment, same windows: the parity contract applies.
        out["events_match"] = out["plain"]["events"] == out["rank1"]["events"]
    print(json.dumps(out), flush=True)
    return 0


def _scale_rank(rank, world, windows):
    """One rank of a ``scale`` launch: both workloads, rank 0's times."""
    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.shard.engine import ShardedEngine

    rows = {}
    for name, (exp, params, _s) in (("tor1k", load_experiment(TOR_CFG)),
                                    ("dense2k", _dense_exp())):
        warm, wall, m = _timed_run(ShardedEngine(exp, params, device="cpu"),
                                   windows, chunk=20)
        rows[name] = {**_row(warm, wall, m),
                      "x2x_max_fill": m["x2x_max_fill"],
                      "ev_overflow": m["ev_overflow"]}
    return rows


def scale_main(devices: list[int], windows: int, json_path: str | None) -> int:
    from shadow1_tpu_torch.shard.launch import RankError, launch

    rows = []
    for n in devices:
        try:
            row = {"mode": "scale", "n_dev": n, "windows": windows,
                   **launch(_scale_rank, n, windows, deadline_s=3000)}
        except RankError as e:
            row = {"mode": "scale", "n_dev": n, "error": str(e)[-300:]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.shardprobe")
    ap.add_argument("mode", choices=["overhead", "scale"])
    ap.add_argument("--config", default=TOR_CFG)
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="scale: the gloo CPU rank counts")
    ap.add_argument("--device", default=None,
                    help="overhead: the device (default: cuda)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.mode == "overhead":
        return overhead_main(args.config, args.windows, args.device)
    return scale_main([int(x) for x in args.devices.split(",")],
                      args.windows, args.json)


if __name__ == "__main__":
    sys.exit(main())

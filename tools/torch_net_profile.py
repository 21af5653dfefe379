"""Where the time goes in the port's net slice on a CUDA card.

    python tools/torch_net_profile.py [NAME] [--warmup N] [--windows N]
        [--profiled N] [--trace PATH]

NAME is a net golden of ``shadow1_tpu_torch/golden/`` (default
``filexfer16k``; also ``tgen50k``, ``tor10k``, ``rung2``, ``dgram4k``,
``bitcoin5k``, ``churn8``, ``fidelity16k``): the experiment and the engine parameters come from the
golden file, with its depth widened to what the run needs. After
``--warmup`` windows (default per configuration, ``WARMUP``: past the
start-up, where the traffic is in full swing), it measures:

1. phase times — ``--windows`` windows, each of the four window phases
   (prepare, rounds, deliver, telem) timed on the host clock with a device
   synchronise after it; events, rounds, events/s, the kernels' launch
   counts and the windows each branch of the compaction ran;
2. a ``torch.profiler`` trace of the next ``--profiled`` windows — device
   time by kernel name, the device's busy time against the wall (its idle
   share), device operations per round, device→host reads per round (the
   ``Memcpy DtoH`` records: every ``bool(tensor)`` and ``.tolist()`` of the
   round loop is one), and with ``--trace`` the Chrome trace.

Prints one JSON line with both and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Windows to run before measuring, by configuration: filexfer16k's clients
# start 10-190 ms in (40 ms windows); tgen50k's streams start at 10 ms
# (10 ms windows); tor10k's clients start from 200 ms on and its first
# cells arrive near window 32 (30 ms windows); bitcoin5k's first
# transaction is created in window 40 (50 ms windows); fidelity16k's
# faults start in window 2 (39 ms windows, 11 in all).
WARMUP = {"filexfer16k": 6, "tgen50k": 6, "tor10k": 30, "rung2": 20,
          "dgram4k": 1, "bitcoin5k": 41, "churn8": 20, "fidelity16k": 3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="filexfer16k",
                    help="net golden to run (shadow1_tpu_torch/golden/"
                         "net_NAME.json)")
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="write the profiler's Chrome trace here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    warmup = args.warmup if args.warmup is not None else WARMUP[args.name]
    print(json.dumps(profile(args.name, warmup, args.windows, args.profiled,
                             args.trace)))
    return 0


def profile(name: str, warmup: int, windows: int, profiled: int,
            trace: str | None = None) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    from shadow1_tpu_torch.config import compiled as ct
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import compact, popk
    from shadow1_tpu_torch.core import engine as E

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gold = json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / f"net_{name}.json").read_text())
    if "build" in gold:
        (builder, kwargs), = gold["build"].items()
        exp = getattr(ct, builder)(**kwargs)
    else:
        exp = ct.experiment_from_arrays(gold["experiment"])
    eng = E.Engine(exp, EngineParams(**gold["params"]), device="cuda")
    t0 = time.perf_counter()
    st = eng.run(n_windows=warmup)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    phases = {}
    for counts in (popk.LAUNCHES, popk.PUSH_ENTRIES):
        for k in counts:
            counts[k] = 0
    for k in compact.WINDOWS:
        compact.WINDOWS[k] = 0
    m0 = E.Engine.metrics_dict(st)
    t_all = time.perf_counter()
    for _ in range(windows):
        fr = E.window_frame(st, eng.ctx)
        for phase, fn in E.window_phases(eng.ctx, eng._handlers,
                                         eng._model.make_handlers,
                                         eng._pre_window):
            t0 = time.perf_counter()
            fr = fn(fr)
            torch.cuda.synchronize()
            phases[phase] = phases.get(phase, 0.0) + time.perf_counter() - t0
        st = fr.st
    wall = time.perf_counter() - t_all
    m1 = E.Engine.metrics_dict(st)
    events = m1["events"] - m0["events"]
    rounds = m1["rounds"] - m0["rounds"]
    launches = {**popk.LAUNCHES, **popk.PUSH_ENTRIES}
    compact_windows = dict(compact.WINDOWS)

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = eng.run(st, n_windows=profiled)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    m2 = E.Engine.metrics_dict(st)
    prof_rounds = m2["rounds"] - m1["rounds"]
    if trace:
        prof.export_chrome_trace(trace)
    rows = []
    for a in prof.key_averages():
        # Device-side records only (kernels, memcpy, memset): CPU ops also
        # carry the device time of what they launched.
        if not str(a.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(a, "self_device_time_total",
                         getattr(a, "self_cuda_time_total", 0))
        rows.append((dev_us, a.key, a.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    d2h = sum(n for _, k, n in rows if "DtoH" in k)
    kernel_us = {}
    for kern in popk.LAUNCHES:
        hits = [(us, n) for us, k, n in rows if f"{kern}_kernel" in k]
        if hits:
            kernel_us[kern] = sum(u for u, _ in hits) / sum(n for _, n in hits)
    return {
        "config": name, "card": card, "hosts": exp.n_hosts,
        "compact_cap": eng.params.compact_cap, "warmup_windows": warmup,
        "warmup_s": warmup_s, "windows": windows,
        "events": events, "rounds": rounds, "wall_s": wall,
        "events_per_s": events / wall, "ms_per_round": wall / rounds * 1e3,
        "phase_s": phases, "launches": launches,
        "launches_per_round": {k: n / rounds for k, n in launches.items()},
        "compact_windows": compact_windows,
        "profiled_windows": profiled, "profiled_rounds": prof_rounds,
        "profiled_events": m2["events"] - m1["events"],
        "profiled_wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / prof_wall,
        "device_ops_per_round": sum(r[2] for r in rows) / prof_rounds,
        "d2h_reads_per_round": d2h / prof_rounds,
        "kernel_us": kernel_us,
        "top_kernels": [{"name": k[:160], "device_us": us, "calls": n}
                        for us, k, n in rows[:40]],
    }


if __name__ == "__main__":
    sys.exit(main())

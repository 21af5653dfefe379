"""Where the time goes in the port's PHOLD slice on a CUDA card.

    python tools/torch_phold_profile.py [--hosts 65536] [--windows 10] [--trace PATH]

Runs the bench workload of ``bench.py`` (16 events per host, ev_cap 48,
outbox_cap 24, 2 ms mean delay, 1 ms windows) on the port after a warm-up
window, twice:

1. phase times — each of the four window phases (prepare, rounds, deliver,
   telem) timed on the host clock with a device synchronise after it;
2. a ``torch.profiler`` trace of the same windows — device time by kernel
   name, the device's busy time against the wall (its idle share), device
   kernels per round, and with ``--trace`` the Chrome trace.

Prints one JSON line with both, the card's name and power limit;
``kernel_us`` is the device time per launch of each of the port's kernels
("in situ").
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=65536)
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--trace", default=None,
                    help="write the profiler's Chrome trace here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(profile(args.hosts, args.windows, args.trace)))
    return 0


def profile(hosts: int, windows: int, trace: str | None = None) -> dict:
    """The two runs above on the kernels ``popk`` launches now; the record
    ``main`` prints."""
    import torch

    sys.path.insert(0, str(ROOT))
    from shadow1_tpu_torch.config.compiled import single_vertex_experiment
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import engine as E
    from shadow1_tpu_torch.core import popk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    exp = single_vertex_experiment(
        n_hosts=hosts, seed=1234, end_time=(2 * windows + 1) * MS,
        latency_ns=MS, model="phold",
        model_cfg={"mean_delay_ns": 2.0 * MS, "init_events": 16})
    eng = E.Engine(exp, EngineParams(ev_cap=48, outbox_cap=24, max_rounds=128),
                   device="cuda")
    st = eng.run(n_windows=1)  # warm-up: kernel library, allocator, caches
    torch.cuda.synchronize()

    phases = {}
    for k in popk.LAUNCHES:
        popk.LAUNCHES[k] = 0
    m0 = E.Engine.metrics_dict(st)
    t_all = time.perf_counter()
    for _ in range(windows):
        fr = E.window_frame(st, eng.ctx)
        for name, fn in E.window_phases(eng.ctx, eng._handlers):
            t0 = time.perf_counter()
            fr = fn(fr)
            torch.cuda.synchronize()
            phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
        st = fr.st
    wall = time.perf_counter() - t_all
    m1 = E.Engine.metrics_dict(st)
    events = m1["events"] - m0["events"]
    rounds = m1["rounds"] - m0["rounds"]
    launches = dict(popk.LAUNCHES)

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = eng.run(st, n_windows=windows)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    prof_rounds = E.Engine.metrics_dict(st)["rounds"] - m1["rounds"]
    if trace:
        prof.export_chrome_trace(trace)
    rows = []
    for a in prof.key_averages():
        # Device-side events only (kernels, memcpy, memset): CPU ops also
        # carry the device time of what they launched, which would count it
        # twice.
        if not str(a.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(a, "self_device_time_total",
                         getattr(a, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, a.key, a.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    kernel_us = {}
    for name in popk.LAUNCHES:
        hits = [(us, n) for us, k, n in rows if f"{name}_kernel" in k]
        if hits:
            kernel_us[name] = sum(u for u, _ in hits) / sum(n for _, n in hits)
    return {
        "card": card, "hosts": hosts, "windows": windows,
        "events": events, "rounds": rounds, "wall_s": wall,
        "events_per_s": events / wall, "phase_s": phases,
        "launches": launches,
        "profiled_wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / prof_wall,
        "device_kernels_per_round": sum(r[2] for r in rows) / prof_rounds,
        "kernel_us": kernel_us,
        "top_kernels": [{"name": k[:160], "device_us": us, "calls": n}
                        for us, k, n in rows[:40]],
    }


if __name__ == "__main__":
    sys.exit(main())

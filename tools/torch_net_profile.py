"""Where the time goes in the port's net slice (NIC + TCP + filexfer) on a
CUDA card.

    python tools/torch_net_profile.py [--groups 2048] [--warmup 6]
        [--windows 5] [--profiled 3] [--trace PATH]

Runs the ``filexfer16k`` layout (``tiled_filexfer_experiment``: groups of
one 20 Mbit server and seven 10 Mbit clients, 40 ms windows, 0.1 % loss,
ev_cap 512) on the port. After ``--warmup`` windows (the clients start
10–190 ms in; the flows are in full swing from window 6), it measures:

1. phase times — ``--windows`` windows, each of the four window phases
   (prepare, rounds, deliver, telem) timed on the host clock with a device
   synchronise after it; events, rounds, events/s and the kernels' launch
   counts;
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
WINDOW_NS = 40_000_000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=2048)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--profiled", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="write the profiler's Chrome trace here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(profile(args.groups, args.warmup, args.windows,
                             args.profiled, args.trace)))
    return 0


def profile(groups: int, warmup: int, windows: int, profiled: int,
            trace: str | None = None) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    from shadow1_tpu_torch.config.compiled import tiled_filexfer_experiment
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import engine as E
    from shadow1_tpu_torch.core import popk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    total = warmup + windows + profiled
    exp = tiled_filexfer_experiment(groups, seed=42, end_time=total * WINDOW_NS)
    eng = E.Engine(exp, EngineParams(ev_cap=512), device="cuda")
    t0 = time.perf_counter()
    st = eng.run(n_windows=warmup)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    phases = {}
    for k in popk.LAUNCHES:
        popk.LAUNCHES[k] = 0
    m0 = E.Engine.metrics_dict(st)
    t_all = time.perf_counter()
    for _ in range(windows):
        fr = E.window_frame(st, eng.ctx)
        for name, fn in E.window_phases(eng.ctx, eng._handlers, eng._pre_window):
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
    for name in popk.LAUNCHES:
        hits = [(us, n) for us, k, n in rows if f"{name}_kernel" in k]
        if hits:
            kernel_us[name] = sum(u for u, _ in hits) / sum(n for _, n in hits)
    return {
        "card": card, "hosts": exp.n_hosts, "warmup_windows": warmup,
        "warmup_s": warmup_s, "windows": windows,
        "events": events, "rounds": rounds, "wall_s": wall,
        "events_per_s": events / wall, "ms_per_round": wall / rounds * 1e3,
        "phase_s": phases, "launches": launches,
        "launches_per_round": {k: n / rounds for k, n in launches.items()},
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

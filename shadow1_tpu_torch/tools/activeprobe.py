"""Per-window active-host statistics — sizing data for sparse compaction.

    python -m shadow1_tpu_torch.tools.activeprobe CONFIG.yaml [--windows N]

The batched engine pays every inner round as a full [C, H] tensor pass
regardless of how many hosts actually execute events — on sparse rungs the
round path is mostly dead lanes. If the per-WINDOW active-host set is small,
the engine can gather active hosts into a narrow static bucket at window
start, run the rounds compact, and scatter back (exact: the active set of a
window is closed under round execution, because cross-host packets defer to
the window-end exchange — handlers only self-push). This tool runs the CPU
oracle and prints the distribution that sizes that bucket:

    {"windows": N, "active_mean": ..., "active_p50/p90/p99/max": ...,
     "events_mean": ..., "rounds_mean (= max events/host + deliver…)": ...}

"active" counts hosts executing ≥1 model event in the window (NIC-batch
rx conversions count toward the host's activity too: converted arrivals
become K_PKT_DELIVER rounds in-window). "rounds" approximates the batch
engine's per-window inner-round count as max events per (host, window) —
the quantity the round loop runs to.
"""

from __future__ import annotations

import argparse
import heapq
import json
from collections import Counter

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.activeprobe")
    ap.add_argument("config")
    ap.add_argument("--windows", type=int, default=None)
    args = ap.parse_args(argv)

    # Oracle-only tool: the numpy oracle runs on the host, no device.
    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.consts import K_PKT
    from shadow1_tpu_torch.cpu_engine import CpuEngine

    exp, params, _ = load_experiment(args.config)
    eng = CpuEngine(exp, params)
    W = eng.window
    n_win = args.windows if args.windows is not None else eng.n_windows
    end = n_win * W

    rx_batch = getattr(eng.model, "rx_batch", False)
    win_hosts: dict[int, set] = {}
    win_events: Counter = Counter()
    win_hostev: dict[int, Counter] = {}

    # Mirror CpuEngine.run()'s loop with per-window accounting; the oracle
    # engine itself stays untouched (no probe cost on the parity path).
    heap, model = eng.heap, eng.model
    while heap and heap[0][0] < end:
        time, tb, _g, host, kind, p = heapq.heappop(heap)
        eng.pending[host] -= 1
        if eng.has_stop and eng._down_at(host, time):
            continue
        w = time // W
        if kind == K_PKT and rx_batch:
            model.rx_convert(host, time, tb, p)
            win_hosts.setdefault(w, set()).add(host)
            continue
        if eng.has_cpu:
            eff = max(time, int(eng.cpu_busy[host]))
            if eff >= (time // W + 1) * W:
                eng.pending[host] += 1
                heapq.heappush(heap, (eff, tb, eng._gseq, host, kind, p))
                eng._gseq += 1
                continue
            eng.cpu_busy[host] = eff + int(eng.cpu_cost[host])
            time = eff
            w = time // W
        win_hosts.setdefault(w, set()).add(host)
        win_events[w] += 1
        win_hostev.setdefault(w, Counter())[host] += 1
        model.handle(host, time, kind, p)

    wins = sorted(win_hosts)
    act = np.array([len(win_hosts[w]) for w in wins])
    evs = np.array([win_events.get(w, 0) for w in wins])
    rnds = np.array([
        max(win_hostev[w].values()) if w in win_hostev else 0 for w in wins
    ])
    pct = lambda a, q: int(np.percentile(a, q)) if len(a) else 0
    print(json.dumps({
        "config": args.config,
        "n_hosts": exp.n_hosts,
        "windows": len(wins),
        "events": int(evs.sum()),
        "active_mean": round(float(act.mean()), 1) if len(act) else 0,
        "active_p50": pct(act, 50),
        "active_p90": pct(act, 90),
        "active_p99": pct(act, 99),
        "active_max": int(act.max()) if len(act) else 0,
        "events_per_window_mean": round(float(evs.mean()), 1) if len(evs) else 0,
        "rounds_proxy_mean": round(float(rnds.mean()), 1) if len(rnds) else 0,
        "rounds_proxy_max": int(rnds.max()) if len(rnds) else 0,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

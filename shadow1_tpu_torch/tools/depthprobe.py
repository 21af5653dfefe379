"""Per-window event-chain depth — sizing data for k-wide round delivery.

    python -m shadow1_tpu_torch.tools.depthprobe CONFIG.yaml [--windows N]

The batched engine pops ONE event per host per round, so a window's round
count is the busiest host's event count (rung-3 Tor: ~47 rounds/window).
The candidate structural fix ("k-wide delivery") would pop
one event per (host, chain) per round, where a *chain* is a serially-
dependent event stream — per-socket TCP traffic, the per-host app stream.
Whether that is worth building depends entirely on the chain-depth
distribution: if the busiest host's events mostly sit on ONE socket
(deep chains), k-wide buys little; if they spread across sockets
(shallow, wide), it collapses the round count.

This tool replays the CPU oracle with per-(window, host, chain)
accounting and prints both depth proxies:

    rounds_now   = max events per (host, window)     — today's round count
    rounds_kwide = max chain depth per (host, window) — the k-wide floor

The k-wide floor is OPTIMISTIC: it assumes cross-chain effects on shared
host state (the NIC uplink clock, RNG draw order, app-level shared
buffers) can be made order-insensitive or rank-serialized within a round,
which is exactly the hard part of building it. Chains: packet-delivery /
timer / tx-resume events key by their socket (payload meta), app wakeups
and NIC-batch conversions key to one per-host chain each.
"""

from __future__ import annotations

import argparse
import heapq
import json
from collections import Counter

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.depthprobe")
    ap.add_argument("config")
    ap.add_argument("--windows", type=int, default=None)
    args = ap.parse_args(argv)

    # Oracle-only tool: the numpy oracle runs on the host, no device.
    from shadow1_tpu_torch.config.experiment import load_experiment
    from shadow1_tpu_torch.consts import (
        K_APP,
        K_PKT,
        K_PKT_DELIVER,
        K_TCP_TIMER,
        K_TX_RESUME,
    )
    from shadow1_tpu_torch.cpu_engine import CpuEngine

    exp, params, _ = load_experiment(args.config)
    eng = CpuEngine(exp, params)
    W = eng.window
    n_win = args.windows if args.windows is not None else eng.n_windows
    end = n_win * W

    rx_batch = getattr(eng.model, "rx_batch", False)
    ev_per_hw: dict[int, Counter] = {}      # window -> Counter[host]
    chain_per_hw: dict[int, Counter] = {}   # window -> Counter[(host, chain)]

    def chain_key(kind, p):
        if kind == K_PKT_DELIVER:
            return ("sock", (p[1] >> 8) & 0xFF)   # dst socket of the segment
        if kind in (K_TCP_TIMER, K_TX_RESUME):
            return ("sock", p[0] & 0xFF)          # event's own socket field
        if kind == K_APP:
            return ("app",)
        if kind == K_PKT:
            return ("nic",)                       # FIFO rx clock is serial
        return ("other", kind)

    heap, model = eng.heap, eng.model
    while heap and heap[0][0] < end:
        time, tb, _g, host, kind, p = heapq.heappop(heap)
        eng.pending[host] -= 1
        if eng.has_stop and eng._down_at(host, time):
            continue
        w = time // W
        if kind == K_PKT and rx_batch:
            model.rx_convert(host, time, tb, p)
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
        ev_per_hw.setdefault(w, Counter())[host] += 1
        chain_per_hw.setdefault(w, Counter())[(host, chain_key(kind, p))] += 1
        model.handle(host, time, kind, p)

    wins = sorted(ev_per_hw)
    now = np.array([max(ev_per_hw[w].values()) for w in wins])
    kwide = []
    for w in wins:
        per_host: Counter = Counter()
        for (host, _c), n in chain_per_hw[w].items():
            per_host[host] = max(per_host[host], n)
        kwide.append(max(per_host.values()))
    kwide = np.array(kwide)
    pct = lambda a, q: int(np.percentile(a, q)) if len(a) else 0
    print(json.dumps({
        "config": args.config,
        "windows": len(wins),
        "events": int(sum(sum(c.values()) for c in ev_per_hw.values())),
        "rounds_now_mean": round(float(now.mean()), 1) if len(now) else 0,
        "rounds_now_p90": pct(now, 90),
        "rounds_now_max": int(now.max()) if len(now) else 0,
        "rounds_kwide_mean": round(float(kwide.mean()), 1) if len(kwide) else 0,
        "rounds_kwide_p90": pct(kwide, 90),
        "rounds_kwide_max": int(kwide.max()) if len(kwide) else 0,
        "kwide_speedup_mean": round(float(now.sum() / max(kwide.sum(), 1)), 2),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

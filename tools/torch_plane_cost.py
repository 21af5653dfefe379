"""The flow-probe and link planes' cost per round on a CUDA card, and
where it goes.

    python tools/torch_plane_cost.py [--reps N] [--split W] [--windows N]

Runs ``fidelity16k`` (``shadow1_tpu_torch/golden/net_fidelity16k.json``,
16,384 hosts, every fidelity gate on) to window ``--split`` (default 6)
with the telemetry ring and the digest words on, then windows
``split``-``split + windows`` (default 2, the busiest) from a copy of that
state with the golden ``net_fidelity16k_obs.json``'s eight probes and the
link accumulator off and on, as ``chip_smoke.py`` phase 13 does:

1. timed in turns (off, on, on, off; ``--reps`` times): ms per round;
2. once each under ``torch.profiler`` (CPU and CUDA), with the planes'
   functions wrapped in ``record_function`` scopes named
   ``plane:FUNCTION@CALLER`` (``links.link_nic_drops`` at its three call
   sites, ``links.link_route_accum``, ``probes.probe_sample`` and
   ``probes.probe_record``): per round, the host ops, the device ops, each
   scope's calls and host time (inclusive), and the ``aten`` ops whose
   count or host time changed most between off and on — the inline plane
   code (``tcp_flush``'s per-lane ``tx_drop_h`` sum) shows there.

Prints one JSON line with the card's name and power limit. Host times
under the profiler include its own per-op cost; compare them with each
other, and the unprofiled ms per round with each other.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--split", type=int, default=6)
    ap.add_argument("--windows", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(measure(args.reps, args.split, args.windows)))
    return 0


def _golden(name: str) -> dict:
    return json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / f"net_{name}.json").read_text())


def _wrap(mod, name: str, prefix: str = "plane"):
    """Replace ``mod.name`` by a wrapper that runs it in a
    ``record_function`` scope named after it and its caller."""
    import torch

    fn = getattr(mod, name)

    @functools.wraps(fn)
    def scoped(*a, **kw):
        caller = sys._getframe(1).f_code.co_name
        with torch.profiler.record_function(f"{prefix}:{name}@{caller}"):
            return fn(*a, **kw)

    setattr(mod, name, scoped)
    return mod, name, fn


def measure(reps: int, split: int, windows: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    from shadow1_tpu_torch import net
    from shadow1_tpu_torch.config import compiled as ct
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.convert import flatten_like_jax, unflatten_like_jax
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.tcp import tcp
    from shadow1_tpu_torch.telemetry import links, probes

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gold, obs = _golden("fidelity16k"), _golden("fidelity16k_obs")
    (builder, kwargs), = gold["build"].items()
    exp = getattr(ct, builder)(**kwargs)

    def params(on: bool):
        extra = (dict(probes=tuple(tuple(p) for p in obs["probes"]),
                      link_telem=1) if on else {})
        return EngineParams(**gold["params"], metrics_ring=gold["windows"],
                            state_digest=1, **extra)

    engines = {on: Engine(exp, params(on), device="cuda")
               for on in (False, True)}
    st0 = engines[True].run(n_windows=split)
    torch.cuda.synchronize()

    def start(on: bool):
        st = unflatten_like_jax(st0, [x.clone() for x in flatten_like_jax(st0)])
        return st if on else st._replace(probes=None, links=None)

    def run(on: bool):
        st = start(on)
        r0 = int(st.metrics.rounds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = engines[on].run(st, n_windows=windows)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, int(st.metrics.rounds) - r0

    for on in (False, True):
        run(on)  # warm-up
    ms = {"off": [], "on": []}
    rounds = None
    for _ in range(reps):
        for on in (False, True, True, False):
            wall, rounds = run(on)
            ms["on" if on else "off"].append(wall / rounds * 1e3)

    saved = [_wrap(m, n) for m, n in (
        (tcp, "link_nic_drops"), (net, "link_nic_drops"),
        (links, "link_route_accum"), (probes, "probe_sample"),
        (probes, "probe_record"))]
    prof_out = {}
    try:
        for on in (False, True):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall, n = run(on)
            cpu, dev_ops = {}, 0
            for a in prof.key_averages():
                if str(a.device_type).endswith("CUDA"):
                    dev_ops += a.count
                    continue
                cpu[a.key] = (a.count, a.cpu_time_total, a.self_cpu_time_total)
            prof_out["on" if on else "off"] = dict(
                wall_ms_per_round=wall / n * 1e3, rounds=n, cpu=cpu,
                device_ops_per_round=dev_ops / n)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    off, on = prof_out["off"], prof_out["on"]
    n = on["rounds"]

    def aten_ops(p):
        return sum(c for k, (c, _, _) in p["cpu"].items()
                   if k.startswith("aten::")) / p["rounds"]

    scopes = {k: {"calls_per_round": c / n, "host_us_per_round": t / n}
              for k, (c, t, _) in on["cpu"].items() if k.startswith("plane:")}
    diff = []
    for k in set(off["cpu"]) | set(on["cpu"]):
        if not k.startswith("aten::"):
            continue
        c0, _, s0 = off["cpu"].get(k, (0, 0, 0))
        c1, _, s1 = on["cpu"].get(k, (0, 0, 0))
        diff.append({"op": k, "calls_per_round": [c0 / off["rounds"], c1 / n],
                     "self_host_us_per_round": [s0 / off["rounds"], s1 / n]})
    diff.sort(key=lambda d: -abs(d["self_host_us_per_round"][1]
                                 - d["self_host_us_per_round"][0]))
    return {
        "config": "fidelity16k", "card": card, "hosts": exp.n_hosts,
        "windows": [split, split + windows], "rounds": rounds, "reps": reps,
        "ms_per_round": ms,
        "ms_per_round_mean": {k: sum(v) / len(v) for k, v in ms.items()},
        "profiled": {
            side: {"wall_ms_per_round": p["wall_ms_per_round"],
                   "aten_ops_per_round": aten_ops(p),
                   "device_ops_per_round": p["device_ops_per_round"]}
            for side, p in prof_out.items()},
        "plane_scopes": scopes,
        "plane_scopes_host_us_per_round": sum(
            s["host_us_per_round"] for s in scopes.values()),
        "aten_diff": diff[:15],
    }


if __name__ == "__main__":
    sys.exit(main())

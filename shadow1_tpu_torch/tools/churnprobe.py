"""churnprobe — fault-plane scenario runner and cross-engine verdict (port
of ``tools/churnprobe.py``).

    python -m shadow1_tpu_torch.tools.churnprobe CONFIG [options]

Runs a faulted experiment (a config with a ``faults:`` section — e.g.
``configs/churn_filexfer.yaml``) on several engines with the state digest
on, and verifies the two properties a churn experiment must have before
its results mean anything:

1. **digest-stream parity** — the per-window state digests
   (``core/digest.py``) are bit-identical across every requested side
   (default: cpu, tpu, and sharded over every card when more than one
   card divides the host count). Killing hosts and links must perturb
   every engine identically; the digest stream is the per-window proof.
2. **drop accounting** — every routed packet is accounted for:
   ``pkts_sent == pkts_delivered + pkts_lost + link_down_pkts + down_pkts
   + ev_overflow_deliveries + x2x_overflow`` (``txn.accounting``).

Side specs: ``cpu`` (the numpy oracle, run in a process of its own beside
the batched sides), ``tpu``, ``sharded[:D]`` (the grammar of
``tools/paritytrace.py``; use paritytrace to BISECT a divergence this
probe reports). The batched sides run on CUDA unless ``--device cpu``.

Prints one JSON verdict to stdout. Exit codes: 0 = all sides agree and
accounting closes, 3 = divergence or accounting hole, 2 = usage error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from shadow1_tpu_torch.core.digest import DIGEST_FIELDS
from shadow1_tpu_torch.txn import accounting

# Counters every side must agree on (includes the fault-plane set).
VERDICT_KEYS = (
    "events", "pkts_sent", "pkts_delivered", "pkts_lost", "link_down_pkts",
    "down_pkts", "down_events", "host_restarts", "tcp_rto", "tcp_fast_rtx",
    "tcp_ooo_drops", "ev_overflow", "ob_overflow",
)


def _digest_rows_cpu(exp, params, n_windows):
    from shadow1_tpu_torch.cpu_engine import CpuEngine

    eng = CpuEngine(exp, params)
    metrics = eng.run(n_windows=n_windows)
    rows = {r["window"]: tuple(r[f] for f in DIGEST_FIELDS)
            for r in eng.digest_rows}
    return dict(metrics), rows


def _digest_rows_batch(engine, n_windows, chunk):
    """Chunked run draining the telemetry ring each boundary — the full
    per-window digest stream whatever the run's length."""
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    rows: dict[int, tuple] = {}
    start = [0]

    def on_chunk(st, _done):
        for r in drain_ring(st, engine.window, start=start[0]):
            if r["type"] == "ring":
                rows[r["window"]] = tuple(r[f] for f in DIGEST_FIELDS)
        start[0] = int(st.metrics.windows)

    st = run_chunked(engine, n_windows=n_windows, chunk=chunk,
                     on_chunk=on_chunk)
    return type(engine).metrics_dict(st), rows


def _rank_side(rank, world, exp, params, n_windows, chunk, device):
    """A sharded side's rank: the chunked run; every rank drains the same
    (global) ring, rank 0's rows are the answer."""
    from shadow1_tpu_torch.shard.engine import ShardedEngine

    return _digest_rows_batch(ShardedEngine(exp, params, device=device),
                              n_windows, chunk)


def side_params(params, chunk):
    return dataclasses.replace(params, state_digest=1,
                               metrics_ring=max(params.metrics_ring, chunk))


def run_side(spec, exp, params, n_windows, chunk, device=None):
    """(metrics, {window: digest words}) of one side."""
    params = side_params(params, chunk)
    if spec == "cpu":
        return _digest_rows_cpu(exp, params, n_windows)
    if spec == "tpu":
        from shadow1_tpu_torch.core.engine import Engine

        return _digest_rows_batch(Engine(exp, params, device=device),
                                  n_windows, chunk)
    if spec.startswith("sharded"):
        from shadow1_tpu_torch.core.engine import resolve_device
        from shadow1_tpu_torch.shard.launch import RankGroup

        _, _, d = spec.partition(":")
        dev = resolve_device(device)
        # NCCL on the card (one card per rank, each engine on its own),
        # gloo on CPU ranks.
        backend = "nccl" if dev.type == "cuda" else "gloo"
        rdev = None if backend == "nccl" else str(dev)
        with RankGroup(int(d or 1), backend, str(dev),
                       threads=1 if dev.type == "cpu" else 0) as g:
            return g.call(_rank_side, exp, params, n_windows, chunk, rdev)
    raise SystemExit(f"unknown side spec {spec!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="churnprobe", description=__doc__)
    ap.add_argument("config")
    ap.add_argument("--sides", default=None,
                    help="comma list of cpu|tpu|sharded[:D] "
                         "(default: cpu,tpu[,sharded:D when D > 1 cards "
                         "divide the host count])")
    ap.add_argument("--windows", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="the batched sides' device (default: cuda)")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.config.experiment import load_experiment

    exp, params, _ = load_experiment(args.config)
    if exp.faults is None:
        print(json.dumps({"error": "config has no faults: section — "
                          "churnprobe verifies the fault plane"}))
        return 2
    n_windows = args.windows
    if n_windows is None:
        n_windows = int(-(-exp.end_time // exp.window))
    sides = args.sides.split(",") if args.sides else None
    if sides is None:
        import torch

        sides = ["cpu", "tpu"]
        n = (torch.cuda.device_count()
             if args.device in (None, "cuda") else 1)
        if n > 1 and exp.n_hosts % n == 0:
            sides.append(f"sharded:{n}")

    results = {}
    oracle = None
    if "cpu" in sides and len(sides) > 1:
        # The oracle is host work: it runs in a process of its own while
        # the batched sides run here.
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        oracle = pool.submit(_digest_rows_cpu, exp,
                             side_params(params, args.chunk), n_windows)
    try:
        for s in sides:
            if s == "cpu" and oracle is not None:
                continue
            results[s] = run_side(s, exp, params, n_windows, args.chunk,
                                  args.device)
        if oracle is not None:
            results["cpu"] = oracle.result()
    finally:
        if oracle is not None:
            pool.shutdown(cancel_futures=True)
    results = {s: results[s] for s in sides}

    ref_spec = sides[0]
    ref_m, ref_rows = results[ref_spec]
    verdict: dict = {
        "config": args.config,
        "windows": n_windows,
        "sides": sides,
        "counters": {s: {k: int(m.get(k, 0)) for k in VERDICT_KEYS}
                     for s, (m, _r) in results.items()},
        "accounting": {s: accounting(m) for s, (m, _r) in results.items()},
    }
    ok = all(v["closes"] for v in verdict["accounting"].values())
    first_div = None
    for s in sides[1:]:
        m, rows = results[s]
        for k in VERDICT_KEYS:
            if int(m.get(k, 0)) != int(ref_m.get(k, 0)):
                ok = False
        common = sorted(set(ref_rows) & set(rows))
        verdict.setdefault("digest_windows_compared", {})[s] = len(common)
        for w in common:
            if rows[w] != ref_rows[w]:
                subs = [DIGEST_FIELDS[i][3:] for i in range(len(DIGEST_FIELDS))
                        if rows[w][i] != ref_rows[w][i]]
                first_div = {"window": w, "side": s, "subsystems": subs}
                ok = False
                break
        if first_div:
            break
    if first_div:
        verdict["first_divergence"] = first_div
        verdict["hint"] = (f"bisect with: python -m shadow1_tpu_torch.tools."
                           f"paritytrace {args.config} {ref_spec} "
                           f"{first_div['side']}")
    verdict["ok"] = ok
    print(json.dumps(verdict))
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())

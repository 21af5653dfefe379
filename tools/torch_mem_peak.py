"""Where a fidelity16k run, a fleet, or a served batch peaks in device
memory on a CUDA card.

    python tools/torch_mem_peak.py          # fidelity16k
    python tools/torch_mem_peak.py fleet    # chip_smoke.py's fleet_filexfer16k
    python tools/torch_mem_peak.py serve    # chip_smoke.py's served tgen50k

Runs ``fidelity16k`` (``shadow1_tpu_torch/golden/net_fidelity16k.json``,
16,384 hosts, every fidelity gate on) twice in chunks of 2 windows, as
``chip_smoke.py`` phase 14 does: from ``ev_cap`` 24 under the retry guard
(the caps grow on the way), and straight at ``ev_cap`` 48. Each run is
recorded by ``torch.cuda.memory._record_memory_history`` (Python stacks);
the allocation trace is walked (``alloc`` / ``free_requested``) to the
high-water mark, and the allocations live there are printed, grouped by
the innermost three frames of the port that made them, beside the
allocator's ``max_memory_allocated``. That is what ``mem.py``'s peak
model (``output``, ``rollback``, ``transient``) is checked against.

``fleet`` records ``chip_smoke.py`` phase 15's ``fleet_filexfer16k`` (4
lanes of filexfer16k folded onto 65,536 host columns) from construction
through its 10 windows, beside ``mem.estimate`` of that fleet.

``serve`` records ``chip_smoke.py`` phase 16's served batch: an in-process
``ServeDaemon`` on the card serving tgen50k for seeds 71 and 72 (JSON
jobs, one 2-lane batch of 100,000 host columns, 20 windows), from the
daemon's step to the batch's end, beside ``mem.estimate`` of the batch
as the daemon prices it.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = (("retry from ev_cap 24", dict(ev_cap=24, on_overflow="retry")),
        ("straight at ev_cap 48", dict(ev_cap=48)))


def frames(entry, n: int = 3) -> str:
    port = [f for f in entry["frames"]
            if "shadow1_tpu_torch" in f["filename"]]
    return " < ".join(f"{Path(f['filename']).name}:{f['line']}:{f['name']}"
                      for f in port[:n]) or "?"


def live_at_peak(trace) -> tuple[int, dict, dict]:
    """(peak bytes, the allocations live there by address, the event at
    the peak) of an allocator trace."""
    live, cur, best, best_i = {}, 0, 0, -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
        elif e["action"] == "free_requested" and e["addr"] in live:
            cur -= live.pop(e["addr"])
        if cur > best:
            best, best_i = cur, i
    held = {}
    for e in trace[:best_i + 1]:
        if e["action"] == "alloc":
            held[e["addr"]] = e
        elif e["action"] == "free_requested":
            held.pop(e["addr"], None)
    return best, held, trace[best_i]


def report(label: str, trace, peak: int, wall: float) -> None:
    best, held, at = live_at_peak(trace)
    groups = collections.Counter()
    for e in held.values():
        groups[frames(e)] += e["size"]
    print(f"{label}: {wall:.1f} s under the recorder; "
          f"max_memory_allocated - base {peak} B; traced peak {best} B "
          f"over {len(trace)} events, at {frames(at, 8)}", flush=True)
    for where, size in groups.most_common(30):
        print(f"  {size:>12} B  {where}")


def fleet(dev) -> None:
    import torch

    import chip_smoke as cs
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.fleet.engine import FleetEngine

    gold, exps = cs.fleet_filexfer_experiments()
    params = EngineParams(**gold["params"], metrics_ring=cs.FLEET_WINDOWS,
                          state_digest=1)
    est = mem.estimate(exps[0], params, fleet=(exps, None))
    print(f"mem.estimate: resident {est.resident_bytes} B, peak "
          f"{est.peak_bytes} B; planes {est.planes}; peaks {est.peaks}",
          flush=True)
    base = cs.clean_allocator(dev)
    torch.cuda.memory._record_memory_history(max_entries=3_000_000,
                                             stacks="python")
    t0 = time.perf_counter()
    eng = FleetEngine(exps, params, device=dev)
    st = eng.run(n_windows=cs.FLEET_WINDOWS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    report("fleet_filexfer16k", trace, peak, wall)
    del st, eng


def serve(dev) -> None:
    import shutil

    import torch

    import chip_smoke as cs
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.serve import client
    from shadow1_tpu_torch.serve.daemon import ServeDaemon

    shutil.rmtree(cs.SERVE_DIR, ignore_errors=True)
    cs.SERVE_DIR.mkdir(parents=True)
    d = ServeDaemon(str(cs.SERVE_DIR / "spool"), ckpt_every_s=1e9,
                    device=dev).start()
    try:
        for seed in cs.SERVE_SEEDS:
            client.submit(d.spool.root, cs.tgen_job(seed), job_id=f"t{seed}")
        d._safe_intake()
        jobs = [d.jobs[f"t{s}"] for s in cs.SERVE_SEEDS]
        exps = [j.exp for j in jobs]
        est = mem.estimate(exps[0], jobs[0].params, fleet=(exps, None))
        print(f"mem.estimate: resident {est.resident_bytes} B, peak "
              f"{est.peak_bytes} B; planes {est.planes}; peaks {est.peaks}",
              flush=True)
        base = cs.clean_allocator(dev)
        torch.cuda.memory._record_memory_history(max_entries=4_000_000,
                                                 stacks="python")
        t0 = time.perf_counter()
        assert d.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        report("served tgen50k (2 lanes)", trace, peak, wall)
    finally:
        d.close()
        shutil.rmtree(cs.SERVE_DIR, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mem_peak: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.core import _build
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.txn import OverflowGuard

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.library()
    dev = torch.device("cuda")
    if sys.argv[1:] in (["fleet"], ["serve"]):
        {"fleet": fleet, "serve": serve}[sys.argv[1]](dev)
        return 0
    gold = cs.net_golden("fidelity16k")
    exp = cs.net_experiment("fidelity16k", gold)
    for label, kw in RUNS:
        base = cs.clean_allocator(dev)
        torch.cuda.memory._record_memory_history(max_entries=3_000_000,
                                                 stacks="python")
        eng = Engine(exp, cs.fid_params(gold, **kw), device=dev)
        guard = (OverflowGuard(eng, make_engine=eng.at_caps)
                 if "on_overflow" in kw else None)
        t0 = time.perf_counter()
        st = run_chunked(eng, n_windows=gold["windows"], chunk=2,
                         guard=guard)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        report(label, trace, peak, wall)
        del st, eng, guard, trace
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port of the simulator on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when it
fails:

1. the card: CUDA must be available; prints its name and power limit;
2. build: compiles the port's hand-written CUDA kernels
   (``shadow1_tpu_torch/csrc/popk.cu``, ``nvcc`` for ``sm_90a``);
3. kernels: each kernel against its plain PyTorch version on the same CUDA
   tensors, at the bench shape (C = 48 event slots, P = 24 outbox slots,
   H = 65,536 hosts, NP = 10 payload words) and on edge cases (a full
   event buffer, no eligible event, a full outbox); outputs must be bit
   equal. Times each kernel, its plain version and its byte bound;
4. the slice: PHOLD through ``Engine(device="cuda")`` — the bench workload
   (65,536 hosts, 16 events per host, ev_cap 48, outbox_cap 24, 2 ms mean
   delay, 1 ms windows) and a 4,096-host lossy PHOLD — whose metrics, hop
   totals and per-host hop digest must equal the JAX engine's, committed
   as ``shadow1_tpu_torch/golden/*.json`` (``tools/torch_golden.py``).
   Every kernel's launch count must rise during the bench run.

It then prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. It imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM device-memory rate (NVIDIA data sheet), the byte bound's rate.
HBM_BYTES_PER_S = 3.35e12
SOURCE = "shadow1_tpu_torch/csrc/popk.cu"
REPLACES = {
    "pop": "shadow1_tpu/core/popk.py:98",
    "push": "shadow1_tpu/core/popk.py:194",
    "obox": "shadow1_tpu/core/popk.py:290",
}
C, P, H = 48, 24, 65536
I32_FREE = 2**31 - 1


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions --------------------------

def random_evbuf(g, dev, *, fill=0.5, full=False):
    """An EventBuf at bench shape from numpy: distinct (t32, tb) keys per
    host (the tie-break's low word is a per-host permutation), many time
    ties, random payload."""
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core.events import EventBuf

    kind = g.integers(1, 7, (C, H))
    if not full:
        kind = np.where(g.random((C, H)) < fill, kind, 0)
    t32 = np.where(kind != 0, g.integers(0, 2000, (C, H)), I32_FREE)
    lo = g.permuted(np.broadcast_to(np.arange(C) * 7919 - 2**30, (H, C)),
                    axis=1).T

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    def rnd(*shape):
        return i32(g.integers(-2**31, 2**31, shape, dtype=np.int64))

    return EventBuf(
        time_hi=rnd(C, H), time_lo=rnd(C, H), t32=i32(t32),
        tb_hi=i32(g.integers(0, 3, (C, H))), tb_lo=i32(lo), kind=i32(kind),
        p=rnd(NP, C, H),
        self_ctr=torch.from_numpy(g.integers(0, 2**40, H)).to(dev),
        epoch=torch.tensor(10**9, dtype=torch.int64, device=dev),
        n_elig=i32(g.integers(0, C, H)),
        u32=torch.tensor(1000, dtype=torch.int32, device=dev))


def random_outbox(g, dev, *, full=False):
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core.outbox import Outbox

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    def rnd(*shape):
        return i32(g.integers(-2**31, 2**31, shape, dtype=np.int64))

    cnt = np.full(H, P) if full else g.integers(0, P + 1, H)
    return Outbox(dst=rnd(P, H), kind=rnd(P, H), depart_hi=rnd(P, H),
                  depart_lo=rnd(P, H), ctr=rnd(P, H), p=rnd(NP, P, H),
                  cnt=i32(cnt),
                  pkt_ctr=torch.from_numpy(g.integers(0, 2**33, H)).to(dev))


def clone(tree):
    return type(tree)(*(x.clone() for x in tree))


def max_abs_err(a, b, what: str) -> int:
    """Largest |a - b| over two trees of integer tensors; raises if any
    leaf differs in shape or dtype."""
    import torch

    if isinstance(a, tuple):
        names = getattr(a, "_fields", range(len(a)))
        return max(max_abs_err(x, y, f"{what}.{f}")
                   for f, x, y in zip(names, a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
    return int(d)


def time_ms(fn, reset, *, reps=20, inner=10) -> float:
    """Stream time of one ``fn()`` call — host launch gaps included — by
    CUDA events around ``inner`` back-to-back calls, over ``reps``
    repetitions; ``reset()`` (not timed) restores the inputs in between."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / (reps * inner)


def device_ms(fn, reset, *, kernel: str, reps=20, inner=10) -> float:
    """Device time per launch of the kernel whose name holds ``kernel``
    while ``fn()`` runs, from ``torch.profiler`` (CUPTI): host launch gaps
    do not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            reset()
            torch.cuda.synchronize()
            with torch.profiler.record_function("timed"):
                for _ in range(inner):
                    fn()
            torch.cuda.synchronize()
    total_us, n = 0.0, 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        if kernel in e.key:
            total_us += e.self_device_time_total
            n += e.count
    require(n == reps * inner,
            f"profiler saw {n} {kernel} launches, expected {reps * inner}")
    return total_us / (reps * inner) / 1e3


def restore(dst, src):
    def reset():
        for d, s in zip(dst, src):
            d.copy_(s)

    return reset


def timings(kernel: str, wrapper, plain, reset) -> dict:
    """The kernel's device time per launch, and the wrapper's and the
    plain version's stream time per call (all in ms). Between repetitions
    ``reset`` restores the planes the kernel updates in place; the plain
    version updates nothing."""
    out = dict(ms=device_ms(wrapper, reset, kernel=kernel))
    reset()
    out["wrapper_ms"] = time_ms(wrapper, reset)
    reset()
    out["plain_ms"] = time_ms(plain, lambda: None)
    return out


def check_pop(g, dev) -> dict:
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core import events as ev
    from shadow1_tpu_torch.core import popk

    err = 0
    for case, buf, until in (
            ("random", random_evbuf(g, dev), 10**9 + 1000),
            ("no eligible event", random_evbuf(g, dev), 10**9)):
        until = torch.tensor(until, dtype=torch.int64, device=dev)
        ref = popk.pop_until_plain(buf, until)
        got = popk.pop_until(clone(buf), until)
        torch.cuda.synchronize()
        e = max_abs_err(ref, got, f"pop[{case}]")
        if e:
            raise AssertionError(f"pop[{case}] differs from its plain "
                                 f"version: max |err| {e}")
        err = max(err, e)
        if case == "random":
            mask = ref[1].mask
            require(int(mask.sum()) > H // 2, "pop: random case pops too little")
    buf = random_evbuf(g, dev)
    until = torch.tensor(10**9 + 1000, dtype=torch.int64, device=dev)
    u32 = ev.until32(buf, until).reshape(1).to(torch.int32).contiguous()
    # Byte bound: read the t32 plane, kind where t32 < u (the popped slot's
    # kind among them), both tie-break words where eligible and the NP
    # payload words at the popped slot; write t32 and kind at that slot and
    # the 4 + NP output rows.
    lt = buf.t32 < u32
    n_lt = int(lt.sum())
    n_elig = int((lt & (buf.kind != 0)).sum())
    n_pop = int((lt & (buf.kind != 0)).any(dim=0).sum())
    nbytes = 4 * (C * H + n_lt + 2 * n_elig + NP * n_pop
                  + 2 * n_pop + (4 + NP) * H)
    reset = restore((buf.t32, buf.kind), (buf.t32.clone(), buf.kind.clone()))
    return dict(max_abs_err=err, bytes=nbytes, **timings(
        "pop_kernel", lambda: popk.pop_until(buf, until),
        lambda: popk.pop_until_plain(buf, until), reset))


def _push_rows(g, dev, mask_p):
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP

    mask = torch.from_numpy(g.random(H) < mask_p).to(dev)
    time_ = torch.from_numpy(10**9 + g.integers(0, 5000, H)).to(dev)
    kind = torch.from_numpy(g.integers(1, 7, H).astype(np.int32)).to(dev)
    p = torch.from_numpy(g.integers(-2**31, 2**31, (NP, H), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    return mask, time_, kind, p


def check_push(g, dev) -> dict:
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core import popk

    err = 0
    for case, buf in (("random", random_evbuf(g, dev)),
                      ("full buffer", random_evbuf(g, dev, full=True))):
        rows = _push_rows(g, dev, 0.7)
        for local in (True, False):
            if local:
                ref = popk.push_local_plain(buf, *rows)
                got = popk.push_local(clone(buf), *rows)
            else:
                tb = torch.from_numpy(g.integers(0, 2**62, H)).to(dev)
                ref = popk.push_back_plain(buf, rows[0], rows[1], tb, *rows[2:])
                got = popk.push_back(clone(buf), rows[0], rows[1], tb, *rows[2:])
            torch.cuda.synchronize()
            e = max_abs_err(ref, got, f"push[{case}]")
            if e:
                raise AssertionError(f"push[{case}, local={local}] differs "
                                     f"from its plain version: max |err| {e}")
            if case == "full buffer":
                require(bool(got[1].eq(rows[0]).all()),
                        "push: a full buffer must overflow every masked host")
            err = max(err, e)
    buf = random_evbuf(g, dev)
    mask, time_, kind, p = _push_rows(g, dev, 0.7)
    free = buf.kind == 0
    first = torch.where(free, torch.arange(C, device=dev)[:, None], C).amin(0)
    n_push = int((mask & (first < C)).sum())
    # Byte bound: read the mask, the kind plane up to each pushing host's
    # first free slot and its 6 + NP value words; write those 6 + NP words
    # into the slot and the overflow row.
    nbytes = 4 * (H + int((first[mask] + 1).clamp(max=C).sum())
                  + 2 * (6 + NP) * n_push + H)
    planes = (buf.time_hi, buf.time_lo, buf.t32, buf.tb_hi, buf.tb_lo,
              buf.kind, buf.p)
    reset = restore(planes, tuple(x.clone() for x in planes))
    return dict(max_abs_err=err, bytes=nbytes, **timings(
        "push_kernel", lambda: popk.push_local(buf, mask, time_, kind, p),
        lambda: popk.push_local_plain(buf, mask, time_, kind, p), reset))


def check_obox(g, dev) -> dict:
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core import popk

    err = 0
    for case, ob in (("random", random_outbox(g, dev)),
                     ("full outbox", random_outbox(g, dev, full=True))):
        mask, time_, kind, p = _push_rows(g, dev, 0.7)
        dst = torch.from_numpy(g.integers(0, H, H).astype(np.int32)).to(dev)
        ref = popk.outbox_append_plain(ob, mask, dst, kind, time_, p)
        got = popk.outbox_append(clone(ob), mask, dst, kind, time_, p)
        torch.cuda.synchronize()
        e = max_abs_err(ref, got, f"obox[{case}]")
        if e:
            raise AssertionError(f"obox[{case}] differs from its plain "
                                 f"version: max |err| {e}")
        if case == "full outbox":
            require(not bool(got[1].any()), "obox: a full outbox takes nothing")
        err = max(err, e)
    ob = random_outbox(g, dev)
    mask, time_, kind, p = _push_rows(g, dev, 0.7)
    dst = torch.from_numpy(g.integers(0, H, H).astype(np.int32)).to(dev)
    ok = mask & (ob.cnt < P)
    n_ok = int(ok.sum())
    # Byte bound: read ok, cnt where ok and the appending hosts' 5 + NP
    # value words; write them at slot cnt[h].
    nbytes = 4 * (H + n_ok + 2 * (5 + NP) * n_ok)
    planes = (ob.dst, ob.kind, ob.depart_hi, ob.depart_lo, ob.ctr, ob.p)
    reset = restore(planes, tuple(x.clone() for x in planes))
    return dict(max_abs_err=err, bytes=nbytes, **timings(
        "obox_kernel",
        lambda: popk.outbox_append(ob, mask, dst, kind, time_, p),
        lambda: popk.outbox_append_plain(ob, mask, dst, kind, time_, p),
        reset))


# -- phase 4: the slice -----------------------------------------------------

def run_golden(name: str, dev, *, count: bool = False) -> dict:
    """Run the golden file's experiment on the port and compare."""
    import numpy as np
    import torch

    from shadow1_tpu_torch.config.compiled import single_vertex_experiment
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import Engine

    gold = json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / f"phold_{name}.json").read_text())
    cfg = gold["config"]
    exp = single_vertex_experiment(
        n_hosts=cfg["n_hosts"], seed=cfg["seed"],
        end_time=cfg["windows"] * cfg["latency_ns"],
        latency_ns=cfg["latency_ns"], loss=cfg["loss"], model="phold",
        model_cfg={"mean_delay_ns": cfg["mean_delay_ns"],
                   "init_events": cfg["init_events"]})
    params = EngineParams(ev_cap=cfg["ev_cap"], outbox_cap=cfg["outbox_cap"],
                          max_rounds=cfg["max_rounds"])
    eng = Engine(exp, params, device=dev)
    torch.cuda.synchronize()
    if count:
        for k in popk.LAUNCHES:
            popk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    st = eng.run(n_windows=cfg["windows"])
    metrics = Engine.metrics_dict(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES) if count else None
    hops = eng.model_summary(st)["hops"]
    got = {"metrics": metrics, "total_hops": int(hops.sum()),
           "hops_sha256": hashlib.sha256(
               np.asarray(hops, "<i8").tobytes()).hexdigest()}
    want = {k: gold[k] for k in got}
    if got != want:
        diff = {k: (want["metrics"][k], v) for k, v in metrics.items()
                if want["metrics"].get(k) != v}
        raise AssertionError(f"{name}: the port differs from the JAX golden "
                             f"(golden, port): {diff or got}")
    return dict(wall_s=wall, events=metrics["events"],
                rounds=metrics["rounds"], windows=metrics["windows"],
                launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from shadow1_tpu_torch.core import _build

    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    info = _build.build()
    _build.library()
    log(f"build: {info['seconds']:.2f} s (built={info['built']})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    g = np.random.default_rng(20261016)
    checks = {"pop": check_pop(g, dev), "push": check_push(g, dev),
              "obox": check_obox(g, dev)}
    for name, r in checks.items():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"kernel {name}: bit-equal to plain; device {r['ms'] * 1e3:.2f} "
            f"us/launch (wrapper call {r['wrapper_ms'] * 1e3:.2f} us); plain "
            f"{r['plain_ms'] * 1e3:.2f} us/call; byte bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bytes']} B at 3.35 TB/s)")

    bench = run_golden("bench", dev, count=True)
    log(f"slice bench (65,536 hosts): {bench['events']} events, "
        f"{bench['rounds']} rounds, {bench['windows']} windows in "
        f"{bench['wall_s']:.3f} s = {bench['events'] / bench['wall_s']:.0f} "
        f"events/s on {card}; equal to the JAX golden")
    again = run_golden("bench", dev)
    log(f"slice bench, second run: {again['wall_s']:.3f} s = "
        f"{again['events'] / again['wall_s']:.0f} events/s")
    lossy = run_golden("lossy", dev)
    log(f"slice lossy (4,096 hosts): {lossy['events']} events in "
        f"{lossy['wall_s']:.3f} s = {lossy['events'] / lossy['wall_s']:.0f} "
        f"events/s; equal to the JAX golden")
    launches = bench["launches"]
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the slice path: {missing}")
    log(f"launches on the bench run: {launches} over {bench['rounds']} rounds")

    kernels = []
    for name, r in checks.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_per_round": launches[name] / bench["rounds"],
            "max_abs_err": r["max_abs_err"], "bit_equal": r["max_abs_err"] == 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "wrapper_ms": r["wrapper_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
            "bound_us": r["bound_ms"] * 1e3,
        })
    print(json.dumps({"kernels": kernels}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

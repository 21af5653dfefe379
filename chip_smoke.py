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
   H = 65,536 hosts, NP = 10 payload words), on a random state and on edge
   cases (a full event buffer, no eligible event, a full outbox; for pop
   and push the bit-exact hazards of ``csrc/popk.cu``: tie-break low words
   above 2**31, past-due keys, a bound at or below the epoch, ties on t32
   and tb_hi, hosts with nothing eligible, times at I64_MAX and far in the
   past, whole tiles of hosts with nothing to push, push-back tie-breaks
   near 2**62; for the outbox packet counters at and above 2**31, 2**32 and
   2**33, departures with low words at and above 2**31 and at I64_MAX, 0-d
   dst and kind, whole tiles with no appending host, cnt at P - 1); outputs
   must be bit equal. Times each kernel, its plain version and its byte
   bound. One public call of ``pop_until``, ``push_local``, ``push_back``
   or ``outbox_append`` must issue exactly one device operation, its
   kernel (``torch.profiler``);
4. the slice: PHOLD through ``Engine(device="cuda")`` — the bench workload
   (65,536 hosts, 16 events per host, ev_cap 48, outbox_cap 24, 2 ms mean
   delay, 1 ms windows) and a 4,096-host lossy PHOLD — whose metrics, hop
   totals and per-host hop digest must equal the JAX engine's, committed
   as ``shadow1_tpu_torch/golden/*.json`` (``tools/torch_golden.py``).
   Every kernel's launch count must rise during the bench run;
5. in the path: one more bench run, with function-level hooks installed
   here (nothing in the package), keeps clones of the exact arguments the
   engine hands each kernel's wrapper at three rounds in the middle of a
   window. On each, the kernel must equal its plain version bit for bit;
   its device time (cold L2), the byte bound for that data, the
   wrapper's stream time and the plain version's are measured;
6. kernels at the net shape: phase 3 again at the net model's shape (C =
   512 event slots, P = 64 outbox slots, H = 16,384 hosts), random state
   and edge cases, bit-equal, timed against the byte bound;
7. the net slice: ``filexfer16k`` (16,384 hosts, 20 windows) and ``rung1``
   (``configs/rung1_filexfer.yaml``, 500 windows) through
   ``Engine(device="cuda")`` with ``state_digest=1``, built in code from
   the golden files (``shadow1_tpu_torch/golden/net_*.json``; no YAML, no
   GraphML). Every digest word of every window, every ``Metrics`` field,
   the summary totals and the SHA-256 of each per-host summary array must
   equal the JAX golden; a digest mismatch names the first differing
   (window, subsystem). Every kernel's launch count must rise during the
   16k run;
8. the net path: one more ``filexfer16k`` run with hooks around the net
   path's call sites of the three kernels (``engine.pop_until``,
   ``popk.push_local`` — which ``engine.push_local_event`` calls — and
   ``tcp.outbox_append``) keeps, in one mid-run window, the arguments of a
   busy, a middling and a sparse round (for push and the outbox the call
   of the round that masks the most hosts); on each the kernel must equal
   its plain version, timed with a cold L2 against that data's byte bound;
9. the app slice, built in code from the goldens as in phase 7 and held
   to them the same way: ``tgen50k`` (``configs/dense_tgen50k.yaml`` at
   its full width, 50,000 hosts, 20 windows), ``rung2``
   (``configs/rung2_tgen100.yaml``, 150 windows) with compaction off and
   again with ``compact_cap`` 48 (windows on both sides of the bucket
   must run), ``tor10k`` (``configs/rung4_tor10k.yaml`` at its full
   width, 10,000 hosts, ``compact_cap`` 1280, 40 windows) and ``dgram4k``
   (a 4,096-host datagram ring with 1 % loss, 20 windows). Each run must
   launch every kernel;
10. the kernels at tor10k's bucket shape (C = 256, P = 64, H = 1,280) as in
   phase 3 (run right after phase 6), and on the arguments that the
   compacted tor10k rounds of window ``TOR_PATH_WINDOW`` hand them, as in
   phase 8 (after phase 9);
11. the fault and fidelity slice, built in code from the goldens and held
   to them as in phase 7: ``bitcoin5k`` (``configs/rung5_bitcoin5k.yaml``
   at its full width, 5,000 hosts, 60 windows: the flood of the first
   transactions), ``churn8`` (``configs/churn_filexfer.yaml`` whole, its
   ``faults:`` included, 150 windows) and ``fidelity16k`` (filexfer16k's
   16,384 hosts with every fidelity gate on: NIC queue bounds, RED AQM,
   the virtual CPU, jitter, host churn, a link outage and a loss ramp; 11
   windows). Each run must launch pop, push and obox, and ``fidelity16k``
   must launch the push kernel through ``push_back`` (the virtual CPU's
   deferrals), counted apart from ``push_local`` (``popk.PUSH_ENTRIES``);
12. the virtual-CPU path: one more ``fidelity16k`` run with the hooks of
   phase 8, which also wrap ``popk.push_back`` (the call site in
   ``engine.run_round``), keeps the ``push_back`` arguments of the rounds
   of window ``FID_PATH_WINDOW`` that defer the most events, the fewest
   (at least one) and about half the most; on each the kernel must equal
   ``push_back_plain`` bit for bit, timed with a cold L2 against that
   data's byte bound.
13. checkpoint and observability: (a) ``fidelity16k`` with 8 flow probes
   and the link accumulator through ``obs.run_with_heartbeat`` with a
   ``Lineage`` snapshot every 3 windows to window 6, then a fresh
   ``Engine`` resumed from ``Lineage.resolve()`` to window 11: every
   digest word, metric and summary must equal ``net_fidelity16k.json``
   (the planes leave them as they were, and the resume is exact), the
   flow and link records must equal ``net_fidelity16k_obs.json`` (their
   SHA-256; its link totals have lost, link-down and NIC-backlog drops),
   and pop, push (``push_local`` and ``push_back``) and obox must launch;
   it prints the snapshot's bytes, save and load seconds, the drains'
   seconds, ms per round with the planes off and on, and device→host
   reads over the same rounds with the planes off and on, which must be
   equal; (b) the JAX package's snapshot of ``churn8`` at window 75
   (``golden/ckpt_churn8_w75.npz``) resumed on the card: every ring row
   of windows 75-150 must equal ``net_churn8.json``; (c) one chunk of
   (a) under ``telemetry.profiler.device_trace``: the Chrome trace (in
   ``build/``, removed after) must hold the run-chunk and the four window
   phases' spans and at least 90 % of each kernel's launches; (d) in a
   fresh process that builds the kernels into an empty directory, the
   ``run_with_heartbeat`` compile span must hold nvcc's whole build.

Each phase's wall time is printed. It then prints a ``{"kernels": [...]}``
line, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
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
# Each kernel's design: "pr1", the first one-thread-per-host kernel, or the
# redesign that computes the whole public function in one launch
# (csrc/popk.cu), named by the change that made it.
DESIGN = {"pop": "pr2", "push": "pr2", "obox": "pr3"}
# Kernel-check shapes (C event slots, P outbox slots, H hosts): the PHOLD
# bench's and the net model's filexfer16k. The phase-3 helpers read the
# module's C, P, H; ``use_shape`` sets them.
BENCH_SHAPE = (48, 24, 65536)
NET_SHAPE = (512, 64, 16384)
# tor10k's compacted bucket: ev_cap 256, outbox_cap 64, compact_cap 1280.
TOR_SHAPE = (256, 64, 1280)
C, P, H = BENCH_SHAPE
I32_FREE = 2**31 - 1
I32_PASTDUE = -(2**31 - 2)
I64_MAX = 2**63 - 1
# Rounds whose kernel arguments the in-path phase keeps: three in the
# middle of the eleventh window (the bench runs about 18 per window).
PATH_WINDOW, PATH_ROUNDS = 10, (5, 8, 11)


# The net in-path phase keeps three rounds of this window of filexfer16k
# (of 20; flows are in full swing, and the first finish in window 14).
NET_PATH_WINDOW = 12
# The Tor in-path phase keeps three rounds of this window of tor10k (of
# 40; clients start from window 6 on, and cells flow from window 32).
TOR_PATH_WINDOW = 36
# The tgen, dgram and Tor runs of phase 9, in order; rung2 runs once per
# compact_cap its golden lists.
APP_RUNS = ("tgen50k", "rung2", "tor10k", "dgram4k")
# The runs of phase 11, in order.
FID_RUNS = ("bitcoin5k", "churn8", "fidelity16k")
# Phase 12 keeps push_back rounds of this window of fidelity16k (of 11;
# hosts are down and restart around it, and flows are in full swing).
FID_PATH_WINDOW = 6


def use_shape(shape) -> None:
    global C, P, H
    C, P, H = shape


def idle_hosts() -> int:
    """The edge cases' idle prefix: 4,096 hosts (128 whole 32-host tiles),
    or at a narrower shape the whole tiles of its first half."""
    return min(4096, H // 2 // 32 * 32)


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

def random_evbuf(g, dev, *, fill=0.5, full=False, edge=False):
    """An EventBuf at bench shape from numpy: distinct (t32, tb) keys per
    host (the tie-break's low word is a per-host permutation), many time
    ties, random payload. ``edge``: the pop kernel's hazards — t32 in
    [-50, 50) with 5 % at I32_PASTDUE (past due), tb_hi in {0, 1}, low
    words distinct per host over the whole i32 range (half of them at or
    above 2**31), every fifth host empty, epoch 2**40."""
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core.events import EventBuf

    kind = g.integers(1, 7, (C, H))
    if not full:
        kind = np.where(g.random((C, H)) < fill, kind, 0)
    if edge:
        kind[:, ::5] = 0
        t32 = g.integers(-50, 50, (C, H))
        t32[g.random((C, H)) < 0.05] = I32_PASTDUE
        perm = g.permuted(np.broadcast_to(np.arange(C, dtype=np.int64), (H, C)),
                          axis=1).T
        lo = (perm * 2654435761 + g.integers(0, 2**32, H)) % 2**32 - 2**31
        hi = g.integers(0, 2, (C, H))
    else:
        t32 = g.integers(0, 2000, (C, H))
        lo = g.permuted(np.broadcast_to(np.arange(C) * 7919 - 2**30, (H, C)),
                        axis=1).T
        hi = g.integers(0, 3, (C, H))
    t32 = np.where(kind != 0, t32, I32_FREE)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    def rnd(*shape):
        return i32(g.integers(-2**31, 2**31, shape, dtype=np.int64))

    return EventBuf(
        time_hi=rnd(C, H), time_lo=rnd(C, H), t32=i32(t32),
        tb_hi=i32(hi), tb_lo=i32(lo), kind=i32(kind),
        p=rnd(NP, C, H),
        self_ctr=torch.from_numpy(g.integers(0, 2**40, H)).to(dev),
        epoch=torch.tensor(2**40 if edge else 10**9, dtype=torch.int64,
                           device=dev),
        n_elig=i32(g.integers(0, C, H)),
        u32=torch.tensor(1000, dtype=torch.int32, device=dev))


def random_outbox(g, dev, *, full=False, edge=False):
    """An Outbox at bench shape from numpy. ``edge``: packet counters at
    and above 2**31 - 1, 2**31, 2**32, 2**33 and at I64_MAX (the next
    append wraps), a third of the hosts at cnt P - 1."""
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core.outbox import Outbox

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    def rnd(*shape):
        return i32(g.integers(-2**31, 2**31, shape, dtype=np.int64))

    cnt = np.full(H, P) if full else g.integers(0, P + 1, H)
    ctr = g.integers(0, 2**33, H)
    if edge:
        cnt[g.random(H) < 1 / 3] = P - 1
        ctr = g.choice(np.array([2**31 - 1, 2**31, 2**32 - 1, 2**32,
                                 2**33 + 5, 2**40, I64_MAX]), H)
    return Outbox(dst=rnd(P, H), kind=rnd(P, H), depart_hi=rnd(P, H),
                  depart_lo=rnd(P, H), ctr=rnd(P, H), p=rnd(NP, P, H),
                  cnt=i32(cnt), pkt_ctr=torch.from_numpy(ctr).to(dev))


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


def device_ops(run, attempts: int = 6) -> list:
    """(name, count, device µs) of each device operation that
    ``torch.profiler`` (CUPTI) records while ``run()`` runs; ``run`` ends
    with a synchronise, and is padded with idle on each side (20 ms,
    doubled at each new attempt), so that no launch sits at an edge of the
    capture window. CUPTI now and then hands back fewer device records
    than the run made (once none at all, once 3 and then 2 of 5, once none
    in three traces in a row; the cause is not known): a trace with none
    is taken again here, up to ``attempts`` times, and callers that count
    launches allow for a short one."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(attempts):
        pad = 0.02 * 2**i
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            run()
            time.sleep(pad)
        ops = [(e.key, e.count, e.self_device_time_total)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.count > 0]
        if ops:
            return ops
    raise AssertionError(f"torch.profiler recorded no device operation in "
                         f"{attempts} traces")


def device_ms(fn, reset, *, kernel: str, reps=20, inner=10,
              attempts=3) -> float:
    """Device time per launch of the kernel whose name holds ``kernel``
    while ``fn()`` runs, from ``torch.profiler`` (CUPTI): host launch gaps
    do not count, nor does what ``reset()`` launches."""
    import torch

    def run():
        for _ in range(reps):
            reset()
            torch.cuda.synchronize()
            for _ in range(inner):
                fn()
            torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        total_us, n = 0.0, 0
        for name, count, us in device_ops(run):
            if kernel in name:
                total_us += us
                n += count
        # CUPTI drops activity records: now and then one, and, once the
        # process has run a large simulation, three or four in every trace
        # whatever its length. Average over the launches it saw, require
        # nearly all of them, and take a trace that saw fewer again.
        if 0.9 * reps * inner <= n <= reps * inner:
            return total_us / n / 1e3
        seen.append(n)
    raise AssertionError(f"profiler saw {seen} {kernel} launches in "
                         f"{attempts} traces, expected {reps * inner}")


def restore(dst, src, flush=None):
    """A reset that copies ``src`` back into ``dst`` and, with ``flush``
    (a tensor larger than the 50 MB L2), evicts the L2 cache after by
    reading it, which leaves no dirty line for the timed kernel to write
    back."""
    def reset():
        for d, s in zip(dst, src):
            d.copy_(s)
        if flush is not None:
            flush.max()

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


def one_device_op(what: str, fn, kernel: str, calls: int = 5,
                  attempts: int = 3) -> None:
    """Each call of ``fn`` (a public wrapper on CUDA tensors) must issue
    exactly one device operation, the kernel named ``kernel``: over
    ``calls`` calls the wrapper must count ``calls`` launches, and the
    profiler may see no other device operation and at most ``calls``
    launches (at least ``calls`` - 1: CUPTI can drop one). A trace that
    saw fewer (CUPTI once dropped two of five records) is taken again, up
    to ``attempts`` times; any other device operation fails at once."""
    import torch

    from shadow1_tpu_torch.core import popk

    name = kernel.removesuffix("_kernel")

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        before = popk.LAUNCHES[name]
        ops = device_ops(run)
        launched = popk.LAUNCHES[name] - before
        # device_ops runs ``run`` again for a trace with no device record.
        require(launched % calls == 0 and launched >= calls,
                f"{what}: {calls} calls counted {launched} {name} launches")
        n = sum(c for _, c, _ in ops)
        require(all(kernel in op for op, _, _ in ops) and n <= calls,
                f"{what}: {calls} calls issued {n} device operations, "
                f"expected {calls} launches of {kernel} and nothing else: "
                f"{ops}")
        if n >= calls - 1:
            return
    raise AssertionError(f"{what}: the profiler saw {n} of {calls} launches "
                         f"of {kernel} in each of {attempts} traces")


def bit_equal(what: str, ref, got) -> int:
    import torch

    torch.cuda.synchronize()
    e = max_abs_err(ref, got, what)
    if e:
        raise AssertionError(f"{what} differs from its plain version: "
                             f"max |err| {e}")
    return e


# Byte bounds: each word the public function must move, once — its inputs
# where the data says they are needed, its outputs in full — for the data
# it is given. The bound is these bytes at the card's memory rate.

def pop_bytes(buf, until) -> int:
    """pop_until: read the t32 plane; kind at each slot the argmin must
    examine — t32 < u32 and t32 at most the host's least eligible t32
    (every slot below u32 where none is eligible); both tie-break words at
    the eligible slots that tie on that least t32 (the popped one among
    them); the NP payload words at the popped slot; the n_elig row, until
    and epoch. Write t32 and kind at that slot, the Popped rows (mask 1 B,
    time 8, tb 8, kind 4, payload 4·NP) and the new n_elig row."""
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core import events as ev

    cap, h = buf.kind.shape
    lt = buf.t32 < ev.until32(buf, until)
    elig = lt & (buf.kind != 0)
    least = torch.where(elig, buf.t32, I32_FREE).amin(0)
    n_exam = int((lt & (buf.t32 <= least)).sum())
    n_tie = int((elig & (buf.t32 == least)).sum())
    n_pop = int(elig.any(dim=0).sum())
    return (4 * cap * h + 4 * n_exam + 8 * n_tie + (4 * NP + 8) * n_pop
            + (1 + 8 + 8 + 4 + 4 * NP + 4 + 4) * h + 16)


def pop_sector_bytes(buf, until) -> int:
    """pop_bytes at the granularity the card moves scattered words in: a
    32-byte sector (8 hosts of one slot row) for each sector that holds a
    kind, tie-break, payload or cleared word the function must touch. Not
    the bound; it says how far the [C, H] layout keeps pop above it."""
    import torch

    from shadow1_tpu_torch.consts import NP
    from shadow1_tpu_torch.core import events as ev

    cap, h = buf.kind.shape
    lt = buf.t32 < ev.until32(buf, until)
    elig = lt & (buf.kind != 0)
    least = torch.where(elig, buf.t32, I32_FREE).amin(0)
    tie = elig & (buf.t32 == least)
    key = torch.where(tie, buf.tb_hi.to(torch.int64) * 2**32
                      + buf.tb_lo.to(torch.int64), I64_MAX)
    popped = tie & (key == key.amin(0))

    def sectors(m):
        pad = torch.nn.functional.pad(m, (0, -h % 8))
        return 32 * int(pad.view(cap, -1, 8).any(-1).sum())

    return (4 * cap * h + sectors(lt & (buf.t32 <= least)) + 2 * sectors(tie)
            + (NP + 2) * sectors(popped)
            + (1 + 8 + 8 + 4 + 4 * NP + 4 + 4) * h + 16)


def push_bytes(buf, mask, local: bool) -> int:
    """push_local / push_back: read the mask row, kind up to each pushing
    host's first free slot, and where a push lands its time, tie-break
    (push_back), kind and NP payload words; write the 6 + NP words into the
    slot; read n_elig, epoch and u32 and write the new n_elig and the
    overflow rows; push_local also reads self_ctr and writes the new one."""
    import torch

    from shadow1_tpu_torch.consts import NP

    cap, h = buf.kind.shape
    free = buf.kind == 0
    first = torch.where(free, torch.arange(cap, device=free.device)[:, None],
                        cap).amin(0)
    n_ok = int((mask & (first < cap)).sum())
    scan = int((first[mask] + 1).clamp(max=cap).sum())
    per_ok = 8 + 4 + 4 * NP + 4 * (6 + NP) + (0 if local else 8)
    return (h + 4 * scan + per_ok * n_ok + (4 + 4 + 1) * h + 12
            + (16 * h if local else 0))


def _appends(ob, mask):
    """bool [H]: the hosts whose packet lands, ok and 0 <= cnt < P."""
    cap = ob.dst.shape[0]
    return mask & (ob.cnt >= 0) & (ob.cnt < cap)


def obox_bytes(ob, mask, dst, kind, depart) -> int:
    """outbox_append: read the mask (1 B), cnt (4) and pkt_ctr (8) rows
    and write the ok, cnt and pkt_ctr rows (1 + 4 + 8); for each host whose
    packet lands read its dst (4), kind (4), depart (8) and NP payload
    words, and write the 5 + NP words at slot cnt[h]. A 0-d dst, kind or
    depart is read once."""
    from shadow1_tpu_torch.consts import NP

    h = ob.dst.shape[1]
    n = int(_appends(ob, mask).sum())
    vals = sum(size * (n if x.dim() else min(n, 1))
               for x, size in ((dst, 4), (kind, 4), (depart, 8)))
    return 26 * h + vals + 4 * NP * n + 4 * (5 + NP) * n


def obox_sector_bytes(ob, mask, dst, kind, depart) -> int:
    """obox_bytes at the granularity the card moves scattered words in:
    the six [H] rows whole; each 32-byte sector of a value row (8 hosts of
    an i32 row, 4 of depart) that holds a landing host's word; and for each
    of the 5 + NP planes, each 32-byte sector (8 hosts of one slot row) that
    a store lands in. Not the bound; it says how far the per-host slot
    rows keep obox above it."""
    import torch

    from shadow1_tpu_torch.consts import NP

    cap, h = ob.dst.shape
    app = _appends(ob, mask)

    def sectors(m, per):
        pad = torch.nn.functional.pad(m, (0, -h % per))
        return 32 * int(pad.view(*m.shape[:-1], -1, per).any(-1).sum())

    def row(x, per):
        return sectors(app, per) if x.dim() else 32 * int(app.any())

    slot = torch.arange(cap, device=app.device)[:, None] == ob.cnt[None, :]
    return (26 * h + row(dst, 8) + row(kind, 8) + row(depart, 4)
            + NP * sectors(app, 8) + (5 + NP) * sectors(slot & app, 8))


def check_pop(g, dev) -> dict:
    import torch

    from shadow1_tpu_torch.core import popk

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    edge = random_evbuf(g, dev, edge=True)
    e0 = 2**40
    err = 0
    for case, buf, until in (
            ("random", random_evbuf(g, dev), 10**9 + 1000),
            ("no eligible event", random_evbuf(g, dev), 10**9),
            ("edge", edge, e0 + 20),
            ("edge, until at the epoch", edge, e0),
            ("edge, until below the epoch", edge, e0 - 7),
            ("edge, until far ahead", edge, e0 + 10**12)):
        ref = popk.pop_until_plain(buf, i64(until))
        got = popk.pop_until(clone(buf), i64(until))
        err = max(err, bit_equal(f"pop[{case}]", ref, got))
        mask = ref[1].mask
        if case == "random":
            require(int(mask.sum()) > H // 2, "pop: random case pops too little")
        if case.startswith("edge, until") and "far" not in case:
            # u32 = 0: only past-due keys pop.
            require(bool(mask.any()) and bool(
                (ref[1].time[mask] < e0).all()), f"pop[{case}]: past-due only")
    lo_pop = ref[1].tb[ref[1].mask] & 0xFFFFFFFF
    require(bool((lo_pop >= 2**31).any()), "pop: no low word >= 2**31 popped")
    b1, u1 = clone(edge), i64(e0 + 20)
    one_device_op("pop_until", lambda: popk.pop_until(b1, u1), "pop_kernel")
    buf = random_evbuf(g, dev)
    until = i64(10**9 + 1000)
    reset = restore((buf.t32, buf.kind), (buf.t32.clone(), buf.kind.clone()))
    return dict(max_abs_err=err, bytes=pop_bytes(buf, until),
                sector_bytes=pop_sector_bytes(buf, until), **timings(
        "pop_kernel", lambda: popk.pop_until(buf, until),
        lambda: popk.pop_until_plain(buf, until), reset))


def _push_rows(g, dev, mask_p, *, edge=False):
    """mask, time, kind, payload rows. ``edge``: 10 % of times at I64_MAX,
    10 % past due by more than 2**31 against an epoch of 2**40, and the
    first ``idle_hosts()`` hosts (whole 32-host tiles) idle."""
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP

    mask = g.random(H) < mask_p
    time_ = 10**9 + g.integers(0, 5000, H)
    if edge:
        mask[:idle_hosts()] = False
        time_ = 2**40 + g.integers(-5000, 5000, H)
        r = g.random(H)
        time_[r < 0.1] = I64_MAX
        time_[(r >= 0.1) & (r < 0.2)] = 2**40 - 2**33 - g.integers(0, 9)
    kind = torch.from_numpy(g.integers(1, 7, H).astype(np.int32)).to(dev)
    p = torch.from_numpy(g.integers(-2**31, 2**31, (NP, H), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    return (torch.from_numpy(mask).to(dev), torch.from_numpy(time_).to(dev),
            kind, p)


def check_push(g, dev) -> dict:
    import torch

    from shadow1_tpu_torch.core import popk

    err = 0
    for case, buf, edge in (("random", random_evbuf(g, dev), False),
                            ("full buffer", random_evbuf(g, dev, full=True), False),
                            ("edge", random_evbuf(g, dev, edge=True), True)):
        rows = _push_rows(g, dev, 0.7, edge=edge)
        for local in (True, False):
            if local:
                ref = popk.push_local_plain(buf, *rows)
                got = popk.push_local(clone(buf), *rows)
            else:
                # Tie-breaks near 2**62, low words on both sides of 2**31.
                tb = torch.from_numpy((1 << 62) + g.integers(-2**33, 2**33, H)).to(dev)
                ref = popk.push_back_plain(buf, rows[0], rows[1], tb, *rows[2:])
                got = popk.push_back(clone(buf), rows[0], rows[1], tb, *rows[2:])
            err = max(err, bit_equal(f"push[{case}, local={local}]", ref, got))
            if case == "full buffer":
                require(bool(got[1].eq(rows[0]).all()),
                        "push: a full buffer must overflow every masked host")
    buf = random_evbuf(g, dev)
    mask, time_, kind, p = _push_rows(g, dev, 0.7)
    b1, tb = clone(buf), buf.self_ctr.clone()
    one_device_op("push_local",
                  lambda: popk.push_local(b1, mask, time_, kind, p), "push_kernel")
    one_device_op("push_back",
                  lambda: popk.push_back(b1, mask, time_, tb, kind, p),
                  "push_kernel")
    planes = (buf.time_hi, buf.time_lo, buf.t32, buf.tb_hi, buf.tb_lo,
              buf.kind, buf.p)
    reset = restore(planes, tuple(x.clone() for x in planes))
    return dict(max_abs_err=err, bytes=push_bytes(buf, mask, True), **timings(
        "push_kernel", lambda: popk.push_local(buf, mask, time_, kind, p),
        lambda: popk.push_local_plain(buf, mask, time_, kind, p), reset))


def _obox_rows(g, dev, *, edge=False, scalar=False):
    """mask, dst, kind, depart, payload for outbox_append. ``edge``: the
    first ``idle_hosts()`` hosts (whole 32-host tiles) idle; departures at
    I64_MAX, at low word 2**31, and with low words just below 2**32 (up to
    5,000 ns, and 2**33 ns, before 2**40). ``scalar``: 0-d dst and kind."""
    import numpy as np
    import torch

    mask, depart, kind, p = _push_rows(g, dev, 0.7, edge=edge)
    dst = torch.from_numpy(g.integers(0, H, H).astype(np.int32)).to(dev)
    if edge:
        at = torch.from_numpy(g.random(H) < 0.1).to(dev)
        depart = torch.where(at, 2**40 + 2**31, depart)
    if scalar:
        dst = torch.tensor(H // 3, dtype=torch.int32, device=dev)
        kind = torch.tensor(5, dtype=torch.int32, device=dev)
    return mask, dst, kind, depart, p


def check_obox(g, dev) -> dict:
    from shadow1_tpu_torch.core import popk

    err = 0
    edge = random_outbox(g, dev, edge=True)
    for case, ob, rows in (
            ("random", random_outbox(g, dev), _obox_rows(g, dev)),
            ("full outbox", random_outbox(g, dev, full=True), _obox_rows(g, dev)),
            ("edge", edge, _obox_rows(g, dev, edge=True)),
            ("edge, 0-d dst and kind", edge,
             _obox_rows(g, dev, edge=True, scalar=True))):
        ref = popk.outbox_append_plain(ob, *rows)
        got = popk.outbox_append(clone(ob), *rows)
        err = max(err, bit_equal(f"obox[{case}]", ref, got))
        if case == "full outbox":
            require(not bool(got[1].any()), "obox: a full outbox takes nothing")
        if case.startswith("edge"):
            require(not bool(got[1][:idle_hosts()].any())
                    and bool(got[1].any()),
                    f"obox[{case}]: idle tiles appended, or nothing did")
            # The counter's wrap and departure low words >= 2**31 appended.
            ok, lo = got[1], rows[3] & 0xFFFFFFFF
            require(bool((ok & (edge.pkt_ctr == I64_MAX)).any())
                    and bool((ok & (lo >= 2**31)).any()),
                    f"obox[{case}]: no append at pkt_ctr I64_MAX or at a "
                    f"departure low word >= 2**31")
    ob1, rows1 = clone(edge), _obox_rows(g, dev, edge=True, scalar=True)
    one_device_op("outbox_append", lambda: popk.outbox_append(ob1, *rows1),
                  "obox_kernel")
    ob = random_outbox(g, dev)
    rows = _obox_rows(g, dev)
    planes = (ob.dst, ob.kind, ob.depart_hi, ob.depart_lo, ob.ctr, ob.p)
    reset = restore(planes, tuple(x.clone() for x in planes))
    return dict(max_abs_err=err, bytes=obox_bytes(ob, *rows[:4]),
                sector_bytes=obox_sector_bytes(ob, *rows[:4]), **timings(
        "obox_kernel", lambda: popk.outbox_append(ob, *rows),
        lambda: popk.outbox_append_plain(ob, *rows), reset))


# -- phase 4: the slice -----------------------------------------------------

def run_golden(name: str, dev, *, count: bool = False) -> dict:
    """Run the golden file's experiment on the port and compare with it."""
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


# -- phase 7: the net slice -------------------------------------------------

def net_golden(name: str) -> dict:
    return json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / f"net_{name}.json").read_text())


def net_experiment(name: str, gold: dict):
    """The golden's experiment, built in code (no YAML, no GraphML), held
    to the golden's SHA-256 of its arrays."""
    from shadow1_tpu_torch.config import compiled as ct

    if "build" in gold:
        (builder, kwargs), = gold["build"].items()
        exp = getattr(ct, builder)(**kwargs)
    else:
        exp = ct.experiment_from_arrays(gold["experiment"])
    sha = hashlib.sha256(json.dumps(ct.experiment_arrays(exp),
                                    sort_keys=True).encode()).hexdigest()
    require(sha == gold["experiment_sha256"],
            f"{name}: the experiment built here is not the golden's")
    return exp


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run_net_golden(name: str, dev, *, count: bool = False,
                   compact_cap: int | None = None) -> dict:
    """Run a net golden's experiment with state_digest=1 through
    Engine(device=dev) and compare: every digest word (the first differing
    (window, subsystem) is named), every Metrics field, the summary
    entries (each summed over hosts) and the SHA-256 of each per-host
    summary array. ``compact_cap`` overrides the golden's (compaction is
    bit-identical, so one golden serves both); the windows each branch of
    ``compact_window_rounds`` ran are returned."""
    import dataclasses

    import numpy as np

    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import compact, popk
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    gold = net_golden(name)
    exp = net_experiment(name, gold)
    windows = gold["windows"]
    params = EngineParams(**gold["params"], metrics_ring=windows,
                          state_digest=1)
    if compact_cap is not None:
        params = dataclasses.replace(params, compact_cap=compact_cap)
    eng = Engine(exp, params, device=dev)
    sync(dev)
    if count:
        for counts in (popk.LAUNCHES, popk.PUSH_ENTRIES):
            for k in counts:
                counts[k] = 0
    for k in compact.WINDOWS:
        compact.WINDOWS[k] = 0
    t0 = time.perf_counter()
    st = eng.init_state()
    init_push = popk.LAUNCHES["push"]
    st = eng.run(st, n_windows=windows)
    metrics = Engine.metrics_dict(st)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES) if count else None
    entries = dict(popk.PUSH_ENTRIES) if count else None
    got = check_net_golden(name, gold, eng, st, drain_ring(st, eng.window))
    return dict(wall_s=wall, events=metrics["events"],
                rounds=metrics["rounds"], windows=metrics["windows"],
                hosts=exp.n_hosts, launches=launches, push_entries=entries,
                init_push=init_push if count else None, metrics=metrics,
                compact_windows=dict(compact.WINDOWS), summary=got)


def check_net_golden(name: str, gold: dict, eng, st, rows,
                     first: int = 0) -> dict:
    """Hold a net run to its golden: the ring ``rows`` of windows ``first``
    on (every digest word; the first differing (window, subsystem) is
    named), every Metrics field, the summary entries (each summed over
    hosts) and the SHA-256 of each per-host summary array. Returns the
    summary sums."""
    import numpy as np

    from shadow1_tpu_torch.core.engine import Engine

    fields = gold["digest_fields"]
    rows = [r for r in rows if r["type"] == "ring"]
    require(len(rows) == gold["windows"] - first,
            f"{name}: {len(rows)} ring rows from window {first}")
    for w, (want, row) in enumerate(zip(gold["digests"][first:], rows),
                                    start=first):
        require(row["window"] == w, f"{name}: ring row {row['window']} "
                f"where window {w} was due")
        for f, x in zip(fields, want):
            if row[f] != x:
                raise AssertionError(
                    f"{name}: first differing digest word: window {w}, "
                    f"subsystem {f.removeprefix('dg_')}: golden {x}, port "
                    f"{row[f]}")
    metrics = Engine.metrics_dict(st)
    diff = {k: (gold["metrics"][k], v) for k, v in metrics.items()
            if gold["metrics"].get(k) != v}
    require(not diff and set(metrics) == set(gold["metrics"]),
            f"{name}: metrics differ from the JAX golden (golden, port): "
            f"{diff}")
    for k in ("ev_overflow", "ob_overflow", "round_cap_hits"):
        require(metrics[k] == 0, f"{name}: {k} = {metrics[k]}")
    summ = eng.model_summary(st)
    got = {k: int(np.asarray(summ[k]).sum()) for k in gold["summary"]}
    require(got == gold["summary"], f"{name}: summary {got} differs from "
            f"the JAX golden's {gold['summary']}")
    for k, want in gold["sha256"].items():
        h = hashlib.sha256(np.asarray(summ[k], "<i8").tobytes()).hexdigest()
        require(h == want, f"{name}: per-host {k} differs from the golden")
    return got


class NetPathCapture:
    """Hooks around the net path's call sites of the kernels' wrappers:
    ``engine.pop_until``, ``popk.push_local`` (``engine.push_local_event``
    imports it at each call, so TCP timers, transmit resumes and app
    wakeups all pass here), ``popk.push_back`` (the virtual CPU's
    deferrals; ``engine.run_round`` calls it through the module, once per
    round) and ``tcp.outbox_append`` (every TCP segment), and around
    ``engine.window_frame``, which counts the windows. In window
    ``window`` every round's pop arguments are cloned before the call, and
    so are the push, push_back and outbox arguments of the round's call
    that masks the most hosts. A round is ranked by the hosts it pops, or,
    with ``rank`` an entry's name, by the hosts that entry's widest call
    masks (phase 12 ranks by the events ``push_back`` defers: the round
    that pops the most may defer none). When a round ends it is kept if it
    is the busiest so far, the sparsest of rank above 0, or the closest to
    half the busiest. Calls pass through unchanged; under compaction they
    see the bucket's planes."""

    def __init__(self, window: int = NET_PATH_WINDOW, rank: str = "pop"):
        self.path_window = window
        self.rank = rank
        self.kept = {}
        self.cur = None
        self._window = -1
        self._saved = []

    def _end_round(self):
        rec, self.cur = self.cur, None
        if rec is None:
            return
        if self.rank != "pop":
            rec["n"] = rec.get(self.rank, (0,))[0]
        if rec["n"] == 0:
            return
        n, kept = rec["n"], self.kept
        if "busy" not in kept or n > kept["busy"]["n"]:
            kept["busy"] = rec
            return
        half = kept["busy"]["n"] / 2
        if "middling" not in kept or abs(n - half) < abs(kept["middling"]["n"] - half):
            kept["middling"] = rec
        if "sparse" not in kept or n < kept["sparse"]["n"]:
            kept["sparse"] = rec

    def cases(self, name: str) -> list:
        recs = {id(r): r for r in self.kept.values()}.values()
        return [r[name][1] for r in sorted(recs, key=lambda r: -r["n"])
                if r.get(name)]

    def actives(self) -> list:
        recs = {id(r): r for r in self.kept.values()}.values()
        return sorted((r["n"] for r in recs), reverse=True)

    @staticmethod
    def _clone_args(args):
        return tuple(clone(a) if isinstance(a, tuple) else
                     a.clone() if hasattr(a, "clone") else a for a in args)

    def _widest(self, name, args):
        if self.cur is None:
            return
        m = int(args[1].sum())
        best = self.cur.get(name)
        if best is None or m > best[0]:
            self.cur[name] = (m, self._clone_args(args))

    def __enter__(self):
        from shadow1_tpu_torch.core import engine, popk
        from shadow1_tpu_torch.tcp import tcp

        pop, push, obox = engine.pop_until, popk.push_local, tcp.outbox_append
        push_back, frame = popk.push_back, engine.window_frame

        def frame_hook(st, ctx):
            # One call per window, rounds or none (tor10k's first windows
            # have no event).
            self._end_round()
            self._window += 1
            return frame(st, ctx)

        def pop_hook(buf, until, extract="sum"):
            self._end_round()
            if self._window != self.path_window:
                return pop(buf, until, extract)
            args = self._clone_args((buf, until))
            out = pop(buf, until, extract)
            self.cur = {"n": int(out[1].mask.sum()), "pop": (0, args)}
            return out

        def push_hook(buf, mask, time_, kind, p):
            self._widest("push", (buf, mask, time_, kind, p))
            return push(buf, mask, time_, kind, p)

        def push_back_hook(buf, mask, time_, tb, kind, p):
            self._widest("push_back", (buf, mask, time_, tb, kind, p))
            return push_back(buf, mask, time_, tb, kind, p)

        def obox_hook(ob, mask, dst, kind, depart, p):
            self._widest("obox", (ob, mask, dst, kind, depart, p))
            return obox(ob, mask, dst, kind, depart, p)

        self._saved = [(engine, "pop_until", pop), (popk, "push_local", push),
                       (popk, "push_back", push_back),
                       (tcp, "outbox_append", obox),
                       (engine, "window_frame", frame)]
        engine.pop_until, popk.push_local = pop_hook, push_hook
        popk.push_back, tcp.outbox_append = push_back_hook, obox_hook
        engine.window_frame = frame_hook
        return self

    def __exit__(self, *exc):
        self._end_round()
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


# -- phase 13: checkpoint and observability ---------------------------------

OBS_DIR = ROOT / "build" / "chip_smoke_obs"
# The lineage of phase 13's split run: a generation every OBS_CHUNK
# windows; the run stops at window OBS_SPLIT and a fresh engine resumes
# from the lineage's head to the golden's end.
OBS_CHUNK, OBS_SPLIT = 3, 6


def obs_params(gold: dict, obs: dict, on: bool):
    """fidelity16k's params with the ring and the digest words, and with
    ``on`` the golden's probes and the link accumulator."""
    from shadow1_tpu_torch.consts import EngineParams

    extra = (dict(probes=tuple(tuple(p) for p in obs["probes"]),
                  link_telem=1) if on else {})
    return EngineParams(**gold["params"], metrics_ring=gold["windows"],
                        state_digest=1, **extra)


def clone_state(st):
    """A deep copy of a state on its device (the kernels update the event
    buffer and outbox planes in place)."""
    from shadow1_tpu_torch.convert import flatten_like_jax, unflatten_like_jax

    return unflatten_like_jax(st, [x.clone() for x in flatten_like_jax(st)])


def sync_reads(run) -> int:
    """Device→host synchronizations while ``run()`` runs, counted by
    ``torch.cuda.set_sync_debug_mode``'s warnings (one per synchronizing
    call: every read of a flag or count back to the host). Some of those
    warnings are issued once a process, so compare counts only after a
    counted warm-up run."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def run_obs_split(dev) -> dict:
    """Phase 13 (a): fidelity16k with 8 probes and the link accumulator
    through ``obs.run_with_heartbeat`` with a lineage snapshot every
    OBS_CHUNK windows to window OBS_SPLIT, then a fresh engine resumed
    from ``Lineage.resolve()`` to the end. Held to both goldens; the
    kernels' launches are counted over the two runs (the first with its
    init, the second without the template state's)."""
    import shutil

    from shadow1_tpu_torch import ckpt
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.lineage import Lineage
    from shadow1_tpu_torch.obs import run_with_heartbeat
    from shadow1_tpu_torch.telemetry import PhaseProfiler
    from shadow1_tpu_torch.telemetry.registry import LINK_FIELDS
    # The golden's record hash (the tool's JAX imports are in its
    # functions).
    from tools.torch_golden import records_sha256

    gold, obs = net_golden("fidelity16k"), net_golden("fidelity16k_obs")
    exp = net_experiment("fidelity16k", gold)
    params = obs_params(gold, obs, on=True)
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    path = str(OBS_DIR / "fidelity16k.npz")
    windows = gold["windows"]
    prof = PhaseProfiler()
    eng = Engine(exp, params, device=dev)
    sync(dev)
    for counts in (popk.LAUNCHES, popk.PUSH_ENTRIES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    st, hb1 = run_with_heartbeat(eng, n_windows=OBS_SPLIT,
                                 every_windows=OBS_CHUNK, stream=False,
                                 ckpt_path=path, ckpt_every_s=0.0,
                                 profiler=prof)
    sync(dev)
    first_s = time.perf_counter() - t0
    first = {**popk.LAUNCHES, **popk.PUSH_ENTRIES}
    del st, eng
    resolved = Lineage(path).resolve()
    require(resolved is not None and resolved.path == path
            and resolved.meta["done_windows"] == OBS_SPLIT
            and not resolved.skipped, f"lineage resolve: {resolved}")
    snap_bytes = os.path.getsize(path)
    eng = Engine(exp, params, device=dev)
    t1 = time.perf_counter()
    st = ckpt.load_state(eng.init_state(), resolved.path)
    sync(dev)
    load_s = time.perf_counter() - t1
    require(int(st.metrics.windows) == OBS_SPLIT,
            f"resumed at window {int(st.metrics.windows)}")
    st6 = clone_state(st)
    # The template state's init launched the seed pushes into a state that
    # load_state threw away: count the resumed run from here.
    sync(dev)
    for counts in (popk.LAUNCHES, popk.PUSH_ENTRIES):
        for k in counts:
            counts[k] = 0
    t1 = time.perf_counter()
    st, hb2 = run_with_heartbeat(eng, st, n_windows=windows - OBS_SPLIT,
                                 every_windows=OBS_CHUNK, stream=False,
                                 profiler=prof)
    sync(dev)
    second_s = time.perf_counter() - t1
    launches = {k: first[k] + n for k, n in popk.LAUNCHES.items()}
    entries = {k: first[k] + n for k, n in popk.PUSH_ENTRIES.items()}
    missing = [k for k, n in {**launches, **entries}.items() if n <= 0]
    require(not missing, f"phase 13: kernels not launched: {missing}")
    check_net_golden("fidelity16k", gold, eng, st,
                     hb1.ring_records + hb2.ring_records)
    flows = hb1.flow_records + hb2.flow_records
    links = hb1.link_records + hb2.link_records
    require(len(flows) == obs["flow_count"]
            and records_sha256(flows) == obs["flow_sha256"],
            f"flow records differ from the JAX golden ({len(flows)} vs "
            f"{obs['flow_count']})")
    require(len(links) == obs["link_count"]
            and records_sha256(links) == obs["link_sha256"],
            f"link records differ from the JAX golden ({len(links)} vs "
            f"{obs['link_count']})")
    last = [r for r in links if r["window"] == windows - 1]
    totals = {f: sum(r[f] for r in last) for f in LINK_FIELDS}
    require(totals == obs["link_totals"], f"link totals {totals}")
    low = {k: totals[k] for k, n in obs["at_least"].items() if totals[k] < n}
    require(not low, f"link columns below their least values: {low}")
    spans = {}
    for e in prof.chrome_trace()["traceEvents"]:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e6)
    return dict(first_s=first_s, second_s=second_s, load_s=load_s,
                snap_bytes=snap_bytes, spans=spans, launches=launches,
                push_entries=entries, rounds=int(st.metrics.rounds),
                flows=len(flows), links=len(links), totals=totals,
                heartbeats=len(hb1.records) + len(hb2.records),
                st6=st6, windows=windows)


def obs_plane_cost(dev, st6) -> dict:
    """Phase 13 (a), the planes' cost: windows 6-8 of fidelity16k (the
    busiest) from ``st6``, the window-6 snapshot loaded, with the planes
    off and on — timed in turns (off, on, on, off: the host sets the pace
    and drifts), in ms per round, and then with their device→host reads
    counted, which must be equal (the same rounds)."""
    from shadow1_tpu_torch.core.engine import Engine

    gold, obs = net_golden("fidelity16k"), net_golden("fidelity16k_obs")
    exp = net_experiment("fidelity16k", gold)
    engines = {on: Engine(exp, obs_params(gold, obs, on), device=dev)
               for on in (False, True)}

    def start(on):
        st = clone_state(st6)
        return st if on else st._replace(probes=None, links=None)

    out = {}
    for on in (False, True):
        warm = start(on)
        sync_reads(lambda: engines[on].run(warm, n_windows=1))
    del warm
    for on in (False, True, True, False):
        st = start(on)
        r0 = int(st.metrics.rounds)
        sync(dev)
        t0 = time.perf_counter()
        st = engines[on].run(st, n_windows=2)
        sync(dev)
        wall = time.perf_counter() - t0
        out.setdefault(f"ms_per_round_{'on' if on else 'off'}", []).append(
            wall / (int(st.metrics.rounds) - r0) * 1e3)
    for label, on in (("off", False), ("on", True)):
        st = start(on)
        r0 = int(st.metrics.rounds)
        box = {}

        def run(eng=engines[on], st=st):
            box["st"] = eng.run(st, n_windows=2)
            sync(dev)

        out[f"reads_{label}"] = sync_reads(run)
        out[f"read_rounds_{label}"] = int(box["st"].metrics.rounds) - r0
    require(out["read_rounds_on"] == out["read_rounds_off"],
            f"the planes changed the rounds: {out}")
    require(out["reads_on"] == out["reads_off"] > 0,
            f"device→host reads differ with the planes on: {out}")
    out["reads_per_round"] = out["reads_on"] / out["read_rounds_on"]
    return out


def obs_churn8_from_jax(dev) -> dict:
    """Phase 13 (b): the JAX package's snapshot of churn8 at window 75
    (``golden/ckpt_churn8_w75.npz``), loaded into the port and run to the
    end; every ring row of windows 75-150, the metrics and the summary
    equal ``golden/net_churn8.json``."""
    from shadow1_tpu_torch import ckpt
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    gold = net_golden("churn8")
    exp = net_experiment("churn8", gold)
    params = EngineParams(**gold["params"], metrics_ring=gold["windows"],
                          state_digest=1)
    eng = Engine(exp, params, device=dev)
    snap = ROOT / "shadow1_tpu_torch" / "golden" / "ckpt_churn8_w75.npz"
    ok, why = ckpt.verify_file(str(snap))
    require(ok, f"{snap.name}: {why}")
    st = ckpt.load_state(eng.init_state(), str(snap))
    first = int(st.metrics.windows)
    require(first == 75, f"{snap.name} holds window {first}")
    r0 = int(st.metrics.rounds)
    for k in popk.LAUNCHES:
        popk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    st = eng.run(st, n_windows=gold["windows"] - first)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES)
    require(all(n > 0 for n in launches.values()),
            f"churn8 resume: kernels not launched: {launches}")
    check_net_golden("churn8", gold, eng, st,
                     drain_ring(st, eng.window, start=first), first=first)
    return dict(wall_s=wall, windows=gold["windows"] - first,
                launches=launches, rounds=int(st.metrics.rounds) - r0)


def trace_kernels(trace: dict) -> dict:
    """Launches of each kernel that a Chrome trace holds."""
    counts = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel":
            for k in ("pop", "push", "obox"):
                if f"{k}_kernel" in e.get("name", ""):
                    counts[k] = counts.get(k, 0) + 1
    return counts


def obs_device_trace(dev, st6, attempts: int = 3) -> dict:
    """Phase 13 (c): one chunk of (a) — windows 6-9 from ``st6``, the
    window-6 snapshot loaded — under ``telemetry.profiler.device_trace``,
    written to
    ``build/``. Its Chrome trace must hold the run-chunk span, the four
    window phases' spans and the three kernels, at least 90 % of each
    kernel's counted launches (CUPTI drops a few records; a short trace
    is taken again)."""
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry import PhaseProfiler, device_trace
    from shadow1_tpu_torch.telemetry.profiler import (
        PH_RUN_CHUNK,
        TRACE_FILE,
        WINDOW_PHASES,
    )

    gold, obs = net_golden("fidelity16k"), net_golden("fidelity16k_obs")
    exp = net_experiment("fidelity16k", gold)
    eng = Engine(exp, obs_params(gold, obs, True), device=dev)
    log_dir = OBS_DIR / "trace"
    want = [PH_RUN_CHUNK, *WINDOW_PHASES.values()]
    seen = []
    for _ in range(attempts):
        st = clone_state(st6)
        sync(dev)
        before = dict(popk.LAUNCHES)
        t0 = time.perf_counter()
        with device_trace(str(log_dir)):
            run_chunked(eng, st, n_windows=OBS_CHUNK, chunk=OBS_CHUNK,
                        profiler=PhaseProfiler())
        wall = time.perf_counter() - t0
        launched = {k: popk.LAUNCHES[k] - before[k] for k in before}
        path = log_dir / TRACE_FILE
        size = path.stat().st_size
        trace = json.loads(path.read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        lacking = [n for n in want if n not in names]
        require(not lacking, f"device trace lacks spans: {lacking}")
        got = trace_kernels(trace)
        del trace
        seen.append(got)
        if all(0.9 * n <= got.get(k, 0) <= n for k, n in launched.items()):
            return dict(wall_s=wall, trace_bytes=size, kernels=got,
                        launched=launched, attempts=len(seen))
    raise AssertionError(f"device trace saw kernels {seen}, launched "
                         f"{launched}, in {attempts} traces")


def compile_span_child(build_dir: str) -> None:
    """Phase 13 (d), run in a fresh process: the kernel build pointed at
    an empty ``build_dir``, then two windows of a 1,024-host PHOLD through
    ``obs.run_with_heartbeat`` with a PhaseProfiler. Prints one JSON line:
    the profiler's spans (seconds) and what ``_build.build`` reported."""
    from shadow1_tpu_torch.config.compiled import single_vertex_experiment
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import _build
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.obs import run_with_heartbeat
    from shadow1_tpu_torch.telemetry import PhaseProfiler

    _build.BUILD_DIR = Path(build_dir)
    _build.LIBRARY = _build.BUILD_DIR / "libpopk.so"
    builds, build = [], _build.build

    def counted_build():
        builds.append(build())
        return builds[-1]

    _build.build = counted_build
    exp = single_vertex_experiment(
        n_hosts=1024, seed=7, end_time=2_000_000, latency_ns=1_000_000,
        model="phold", model_cfg={"mean_delay_ns": 2_000_000,
                                  "init_events": 8})
    eng = Engine(exp, EngineParams(ev_cap=32, outbox_cap=16), device="cuda")
    prof = PhaseProfiler()
    st, _ = run_with_heartbeat(eng, n_windows=2, every_windows=1,
                               stream=False, profiler=prof)
    require(int(st.metrics.windows) == 2, "the child ran no window")
    spans = {}
    for e in prof.chrome_trace()["traceEvents"]:
        if e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e6)
    print(json.dumps({"spans": spans, "builds": [
        {"seconds": b["seconds"], "built": b["built"]} for b in builds]}))


def obs_compile_span() -> dict:
    """Phase 13 (d): in a process that has not built the kernels
    (``compile_span_child``), the compile span holds the whole nvcc
    build, and it is the only compile span."""
    build_dir = OBS_DIR / "fresh_build"
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.compile_span_child(sys.argv[1])", str(build_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"compile-span child failed: {proc.stderr[-3000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    require(len(r["builds"]) == 1 and r["builds"][0]["built"],
            f"the child did not build the kernels: {r}")
    nvcc_s = r["builds"][0]["seconds"]
    compile_s = r["spans"].get("compile", [])
    require(len(compile_s) == 1 and compile_s[0] >= nvcc_s > 0,
            f"the compile span does not hold the build: {r}")
    return dict(compile_s=compile_s[0], nvcc_s=nvcc_s,
                init_s=sum(r["spans"].get("init", [])))


def phase_obs(dev, card: str) -> dict:
    """Phase 13's three parts in order, each printed; returns (a)'s run."""
    import shutil

    split = run_obs_split(dev)
    sp = split["spans"]
    n_probes = len(net_golden("fidelity16k_obs")["probes"])
    log(f"checkpoint and observability, fidelity16k with {n_probes} "
        f"probes and the link accumulator: windows 0-{OBS_SPLIT} in "
        f"{split['first_s']:.3f} s through run_with_heartbeat with a "
        f"lineage snapshot every {OBS_CHUNK} windows, resumed from "
        f"Lineage.resolve() in a fresh engine, windows {OBS_SPLIT}-"
        f"{split['windows']} in "
        f"{split['second_s']:.3f} s; every digest word, metric and summary "
        f"equal to net_fidelity16k.json, {split['flows']} flow and "
        f"{split['links']} link records equal to net_fidelity16k_obs.json "
        f"(final link totals {split['totals']}); launches "
        f"{split['launches']}, push by entry {split['push_entries']} over "
        f"{split['rounds']} rounds, on {card}")
    log(f"  snapshot {split['snap_bytes']} bytes; save s "
        f"{[round(x, 4) for x in sp.get('checkpoint', [])]}; load "
        f"{split['load_s']:.4f} s; drain s per chunk "
        f"{[round(x, 4) for x in sp.get('drain', [])]}; run-chunk s "
        f"{[round(x, 4) for x in sp.get('run-chunk', [])]}")
    cs = obs_compile_span()
    log(f"  compile span in a fresh process (a 1,024-host PHOLD, the "
        f"kernels built into an empty directory): {cs['compile_s']:.4f} s, "
        f"holding nvcc's {cs['nvcc_s']:.4f} s; init {cs['init_s']:.4f} s")
    cost = obs_plane_cost(dev, split["st6"])
    off, on = cost["ms_per_round_off"], cost["ms_per_round_on"]
    log(f"  planes off / on: {sum(off) / 2:.3f} / {sum(on) / 2:.3f} ms per "
        f"round (fidelity16k windows 6-8, run off, on, on, off: "
        f"{off[0]:.3f}, {on[0]:.3f}, {on[1]:.3f}, {off[1]:.3f}); "
        f"device→host reads {cost['reads_off']} / {cost['reads_on']} over "
        f"{cost['read_rounds_on']} rounds of windows 6-8 "
        f"({cost['reads_per_round']:.2f} per round, equal)")
    c8 = obs_churn8_from_jax(dev)
    log(f"  churn8 from the JAX package's window-75 snapshot: windows "
        f"75-150 ({c8['rounds']} rounds) in {c8['wall_s']:.3f} s, every "
        f"ring row, metric and summary equal to net_churn8.json; launches "
        f"{c8['launches']}")
    tr = obs_device_trace(dev, split.pop("st6"))
    log(f"  device trace of windows 6-9: {tr['trace_bytes']} bytes, the "
        f"run-chunk and four window-phase spans, kernels {tr['kernels']} of "
        f"{tr['launched']} launched ({tr['attempts']} trace(s)), "
        f"{tr['wall_s']:.3f} s")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    return split


# -- phase 5: the kernels on the arguments of the main path -----------------

class PathCapture:
    """Function-level hooks around the names through which the engine and
    the PHOLD handler call the kernels' wrappers (``engine.pop_until``,
    ``phold.push_local``, ``phold.outbox_append``). They keep clones of
    the arguments of rounds ``PATH_ROUNDS`` of window ``PATH_WINDOW`` —
    taken before the call, since the kernels update planes in place — and
    otherwise pass every call through unchanged."""

    def __init__(self):
        self.cases = {"pop": [], "push": [], "obox": []}
        self._until, self._window, self._round, self._on = None, -1, -1, False
        self._saved = []

    def _keep(self, name, args):
        self.cases[name].append(tuple(
            clone(a) if isinstance(a, tuple) else a.clone() for a in args))

    def __enter__(self):
        from shadow1_tpu_torch.core import engine, phold

        pop, push, obox = engine.pop_until, phold.push_local, phold.outbox_append

        def pop_hook(buf, until, extract="sum"):
            if until is not self._until:  # win_end: one tensor per window
                self._until, self._window, self._round = until, self._window + 1, -1
            self._round += 1
            self._on = (self._window == PATH_WINDOW
                        and self._round in PATH_ROUNDS)
            if self._on:
                self._keep("pop", (buf, until))
            return pop(buf, until, extract)

        def push_hook(buf, mask, time_, kind, p):
            if self._on:
                self._keep("push", (buf, mask, time_, kind, p))
            return push(buf, mask, time_, kind, p)

        def obox_hook(ob, mask, dst, kind, depart, p):
            if self._on:
                self._keep("obox", (ob, mask, dst, kind, depart, p))
            return obox(ob, mask, dst, kind, depart, p)

        self._saved = [(engine, "pop_until", pop), (phold, "push_local", push),
                       (phold, "outbox_append", obox)]
        engine.pop_until, phold.push_local = pop_hook, push_hook
        phold.outbox_append = obox_hook
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def check_path(name: str, cases, dev, flush, expect=len(PATH_ROUNDS)) -> dict:
    """The kernel on each kept main-path argument set: bit-equal to its
    plain version; its device time per launch with the L2 cache evicted
    before each launch (the bound is a device-memory bound); the byte bound
    of that data; the wrapper's stream time per call. Means over cases.
    ``expect``: how many argument sets there must be (a range for the net
    path, where a round may hold no push)."""
    from shadow1_tpu_torch.core import popk

    lo, hi = (expect, expect) if isinstance(expect, int) else expect
    require(lo <= len(cases) <= hi,
            f"in-path {name}: kept {len(cases)} argument sets, expected "
            f"{expect}")
    wrapper, plain = {
        "pop": (popk.pop_until, popk.pop_until_plain),
        "push": (popk.push_local, popk.push_local_plain),
        "push_back": (popk.push_back, popk.push_back_plain),
        "obox": (popk.outbox_append, popk.outbox_append_plain)}[name]
    kernel = "push_kernel" if name == "push_back" else f"{name}_kernel"
    ms, wrap_ms, plain_ms, nbytes, sector_bytes, err, active = (
        [], [], [], [], [], 0, [])
    for i, args in enumerate(cases):
        ref = plain(*args)
        got = wrapper(clone(args[0]), *args[1:])
        err = max(err, bit_equal(f"{name}[in path, case {i}]", ref, got))
        first = args[0]
        if name == "pop":
            nbytes.append(pop_bytes(first, args[1]))
            sector_bytes.append(pop_sector_bytes(first, args[1]))
            active.append(int(ref[1].mask.sum()))
        elif name in ("push", "push_back"):
            nbytes.append(push_bytes(first, args[1], name == "push"))
            active.append(int(args[1].sum()))
        else:
            nbytes.append(obox_bytes(*args[:5]))
            sector_bytes.append(obox_sector_bytes(*args[:5]))
            active.append(int(ref[1].sum()))
        work = clone(first)
        planes = [x for x in work if x.dim() >= 2]
        saved = [x.clone() for x in planes]
        call = (lambda w=work, a=args: wrapper(w, *a[1:]))
        ms.append(device_ms(call, restore(planes, saved, flush),
                            kernel=kernel, reps=120, inner=1))
        restore(planes, saved)()
        wrap_ms.append(time_ms(call, restore(planes, saved)))
        plain_ms.append(time_ms(lambda a=args: plain(*a), lambda: None))
    n = len(cases)
    return dict(path_ms=sum(ms) / n, path_bytes=sum(nbytes) / n,
                path_wrapper_ms=sum(wrap_ms) / n,
                path_plain_ms=sum(plain_ms) / n, path_err=err,
                path_active=active, path_case_ms=ms, path_case_bytes=nbytes,
                path_case_sector_bytes=sector_bytes)


def report_kernel(name: str, r: dict, shape: str) -> None:
    r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"kernel {name} at {shape} shape: bit-equal to plain; device "
        f"{r['ms'] * 1e3:.2f} us/launch (wrapper call "
        f"{r['wrapper_ms'] * 1e3:.2f} us); plain {r['plain_ms'] * 1e3:.2f} "
        f"us/call; byte bound {r['bound_ms'] * 1e3:.2f} us ({r['bytes']} B "
        f"at 3.35 TB/s)")
    if "sector_bytes" in r:
        log(f"  {name}: 32-byte sectors it must touch {r['sector_bytes']} B "
            f"= {r['sector_bytes'] / HBM_BYTES_PER_S * 1e6:.2f} us")


def report_path(name: str, r: dict, where: str) -> None:
    r["path_bound_ms"] = r["path_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"kernel {name} in the {where} (active hosts {r['path_active']}): "
        f"bit-equal to plain; device {r['path_ms'] * 1e3:.2f} us/launch with "
        f"a cold L2 (by case {[round(x * 1e3, 2) for x in r['path_case_ms']]}"
        f"; wrapper call {r['path_wrapper_ms'] * 1e3:.2f} us; plain "
        f"{r['path_plain_ms'] * 1e3:.2f} us/call); byte bound "
        f"{r['path_bound_ms'] * 1e3:.2f} us ({r['path_bytes']:.0f} B; by case "
        f"{r['path_case_bytes']})")
    if r["path_case_sector_bytes"]:
        log(f"  {name} in the {where}: 32-byte sectors it must touch, by case "
            f"{r['path_case_sector_bytes']} B")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from shadow1_tpu_torch.core import _build

    t_start = time.perf_counter()
    phase_s = {}

    def phase_done(name: str, t0: float) -> None:
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s wall")

    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    log(f"build: {info['seconds']:.2f} s (built={info['built']})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    phase_done("build", t0)

    t0 = time.perf_counter()
    g = np.random.default_rng(20261016)
    use_shape(BENCH_SHAPE)
    checks = {"pop": check_pop(g, dev), "push": check_push(g, dev),
              "obox": check_obox(g, dev)}
    for name, r in checks.items():
        report_kernel(name, r, "bench")
    phase_done("kernels at bench shape", t0)

    t0 = time.perf_counter()
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
    phase_done("PHOLD slice", t0)

    t0 = time.perf_counter()
    with PathCapture() as cap:
        run_golden("bench", dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for name, r in checks.items():
        r.update(check_path(name, cap.cases[name], dev, flush))
        report_path(name, r, f"PHOLD path (window {PATH_WINDOW}, rounds "
                    f"{PATH_ROUNDS})")
    del cap
    phase_done("PHOLD path", t0)

    t0 = time.perf_counter()
    use_shape(NET_SHAPE)
    net_checks = {"pop": check_pop(g, dev), "push": check_push(g, dev),
                  "obox": check_obox(g, dev)}
    use_shape(BENCH_SHAPE)
    for name, r in net_checks.items():
        report_kernel(name, r, "net")
    phase_done("kernels at net shape", t0)

    t0 = time.perf_counter()
    use_shape(TOR_SHAPE)
    tor_checks = {"pop": check_pop(g, dev), "push": check_push(g, dev),
                  "obox": check_obox(g, dev)}
    use_shape(BENCH_SHAPE)
    for name, r in tor_checks.items():
        report_kernel(name, r, "Tor bucket")
    phase_done("kernels at Tor bucket shape", t0)

    t0 = time.perf_counter()
    net = run_net_golden("filexfer16k", dev, count=True)
    log(f"net slice filexfer16k ({net['hosts']} hosts): {net['events']} "
        f"events, {net['rounds']} rounds, {net['windows']} windows in "
        f"{net['wall_s']:.3f} s = {net['events'] / net['wall_s']:.0f} "
        f"events/s, {net['wall_s'] / net['rounds'] * 1e3:.2f} ms/round on "
        f"{card}; every metric, summary, hash and digest word equal to the "
        f"JAX golden")
    net_launches = net["launches"]
    missing = [k for k, n in net_launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the net path: {missing}")
    log(f"launches on the filexfer16k run: {net_launches} over "
        f"{net['rounds']} rounds")
    rung1 = run_net_golden("rung1", dev)
    log(f"net slice rung1 ({rung1['hosts']} hosts): {rung1['events']} "
        f"events, {rung1['rounds']} rounds, {rung1['windows']} windows in "
        f"{rung1['wall_s']:.3f} s ({rung1['wall_s'] / rung1['rounds'] * 1e3:.2f}"
        f" ms/round); equal to the JAX golden")
    phase_done("net slice", t0)

    t0 = time.perf_counter()
    with NetPathCapture() as ncap:
        run_net_golden("filexfer16k", dev)
    log(f"net path: kept rounds of window {NET_PATH_WINDOW} with "
        f"{ncap.actives()} popping hosts")
    for name, r in net_checks.items():
        r.update(check_path(name, ncap.cases(name), dev, flush, expect=(1, 3)))
        report_path(name, r, f"net path (window {NET_PATH_WINDOW})")
    del ncap, flush
    phase_done("net path", t0)

    t0 = time.perf_counter()
    apps = {}
    for name in APP_RUNS:
        for cap in net_golden(name).get("compact_caps", [None]):
            label = name if not cap else f"{name}/compact{cap}"
            r = apps[label] = run_net_golden(name, dev, count=True,
                                             compact_cap=cap)
            missing = [k for k, n in r["launches"].items() if n <= 0]
            require(not missing, f"{label}: kernels not launched: {missing}")
            log(f"app slice {label} ({r['hosts']} hosts): {r['events']} "
                f"events, {r['rounds']} rounds, {r['windows']} windows in "
                f"{r['wall_s']:.3f} s = {r['wall_s'] / r['rounds'] * 1e3:.2f}"
                f" ms/round, {r['events'] / r['wall_s']:.0f} events/s on "
                f"{card}; launches {r['launches']}; compaction windows "
                f"{r['compact_windows']}; equal to the JAX golden")
    both = apps["rung2/compact48"]["compact_windows"]
    require(both["compact"] > 0 and both["full"] > 0,
            f"rung2 with compact_cap 48 ran one branch only: {both}")
    require(apps["tor10k"]["compact_windows"]["compact"] > 0,
            "tor10k ran no compacted window")
    tor = apps["tor10k"]
    phase_done("app slice", t0)

    t0 = time.perf_counter()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    with NetPathCapture(TOR_PATH_WINDOW) as tcap:
        run_net_golden("tor10k", dev)
    log(f"Tor path: kept rounds of window {TOR_PATH_WINDOW} with "
        f"{tcap.actives()} popping hosts")
    for name, r in tor_checks.items():
        r.update(check_path(name, tcap.cases(name), dev, flush, expect=(1, 3)))
        report_path(name, r, f"Tor path (window {TOR_PATH_WINDOW})")
    del tcap, flush
    phase_done("Tor path", t0)

    t0 = time.perf_counter()
    fid = {}
    for name in FID_RUNS:
        r = fid[name] = run_net_golden(name, dev, count=True)
        missing = [k for k, n in r["launches"].items() if n <= 0]
        require(not missing, f"{name}: kernels not launched: {missing}")
        m = r["metrics"]
        log(f"fault and fidelity slice {name} ({r['hosts']} hosts): "
            f"{r['events']} events, {r['rounds']} rounds, {r['windows']} "
            f"windows ({r['rounds'] / r['windows']:.2f} rounds/window) in "
            f"{r['wall_s']:.3f} s = {r['wall_s'] / r['rounds'] * 1e3:.2f} "
            f"ms/round, {r['events'] / r['wall_s']:.0f} events/s on {card}; "
            f"launches {r['launches']}, push by entry {r['push_entries']} "
            f"({r['init_push']} at init); equal to the JAX golden")
        log(f"  {name} gates: " + json.dumps({k: m[k] for k in (
            "nic_tx_drops", "nic_rx_drops", "nic_aqm_drops", "down_events",
            "down_pkts", "link_down_pkts", "host_restarts", "fires_pkt")}))
    btc = fid["bitcoin5k"]
    log(f"bitcoin5k push launches per round: "
        f"{(btc['launches']['push'] - btc['init_push']) / btc['rounds']:.2f}"
        f" (after the {btc['init_push']} pushes of init_state); summary "
        f"total_seen {btc['summary']['total_seen']}, total_tx_rx "
        f"{btc['summary']['total_tx_rx']}")
    fx = fid["fidelity16k"]
    require(fx["push_entries"]["push_back"] > 0,
            "fidelity16k: push_back never launched its kernel")
    require(fx["push_entries"]["push_back"] == fx["rounds"],
            f"fidelity16k: push_back launched {fx['push_entries']} times "
            f"in {fx['rounds']} rounds, expected once per round")
    for name in ("bitcoin5k", "churn8"):
        require(fid[name]["push_entries"]["push_back"] == 0,
                 f"{name}: push_back launched without the virtual CPU")
    phase_done("fault and fidelity slice", t0)

    t0 = time.perf_counter()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    with NetPathCapture(FID_PATH_WINDOW, rank="push_back") as bcap:
        run_net_golden("fidelity16k", dev)
    log(f"virtual-CPU path: kept rounds of window {FID_PATH_WINDOW} with "
        f"{bcap.actives()} deferred events")
    back = check_path("push_back", bcap.cases("push_back"), dev, flush,
                      expect=(1, 3))
    report_path("push_back", back, f"virtual-CPU path (fidelity16k window "
                f"{FID_PATH_WINDOW})")
    del bcap, flush
    phase_done("virtual-CPU path", t0)

    t0 = time.perf_counter()
    split = phase_obs(dev, card)
    phase_done("checkpoint and observability", t0)

    kernels = []
    for name, r in checks.items():
        n = net_checks[name]
        tk = tor_checks[name]
        err = max(r["max_abs_err"], r["path_err"], n["max_abs_err"],
                  n["path_err"], tk["max_abs_err"], tk["path_err"])
        if name == "push":
            err = max(err, back["path_err"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "design": DESIGN[name],
            "launches": launches[name],
            "launches_per_round": launches[name] / bench["rounds"],
            "max_abs_err": err, "bit_equal": err == 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "wrapper_ms": r["wrapper_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "us": r["ms"] * 1e3, "plain_us": r["plain_ms"] * 1e3,
            "bound_us": r["bound_ms"] * 1e3,
            "wrapper_us": r["wrapper_ms"] * 1e3,
            "path_us": r["path_ms"] * 1e3,
            "path_bound_us": r["path_bound_ms"] * 1e3,
            "path_wrapper_us": r["path_wrapper_ms"] * 1e3,
            "net_launches": net_launches[name],
            "net_launches_per_round": net_launches[name] / net["rounds"],
            "net_us": n["ms"] * 1e3, "net_plain_us": n["plain_ms"] * 1e3,
            "net_bound_us": n["bound_ms"] * 1e3,
            "net_path_us": n["path_ms"] * 1e3,
            "net_path_bound_us": n["path_bound_ms"] * 1e3,
            "net_path_case_us": [x * 1e3 for x in n["path_case_ms"]],
            "net_path_active": n["path_active"],
            "tor_launches": tor["launches"][name],
            "tor_launches_per_round": tor["launches"][name] / tor["rounds"],
            "tor_us": tk["ms"] * 1e3, "tor_plain_us": tk["plain_ms"] * 1e3,
            "tor_bound_us": tk["bound_ms"] * 1e3,
            "tor_path_us": tk["path_ms"] * 1e3,
            "tor_path_bound_us": tk["path_bound_ms"] * 1e3,
            "tor_path_case_us": [x * 1e3 for x in tk["path_case_ms"]],
            "tor_path_active": tk["path_active"],
            "app_launches": {k: a["launches"][name] for k, a in apps.items()},
            "fid_launches": {k: a["launches"][name] for k, a in fid.items()},
            "fid_launches_per_round": {
                k: a["launches"][name] / a["rounds"] for k, a in fid.items()},
            "obs_launches": split["launches"][name],
            "obs_launches_per_round": split["launches"][name]
            / split["rounds"],
        })
        if name == "push":
            kernels[-1].update({
                "push_back_launches": fx["push_entries"]["push_back"],
                "push_back_launches_per_round":
                    fx["push_entries"]["push_back"] / fx["rounds"],
                "push_back_path_err": back["path_err"],
                "push_back_path_us": back["path_ms"] * 1e3,
                "push_back_path_bound_us": back["path_bound_ms"] * 1e3,
                "push_back_path_wrapper_us": back["path_wrapper_ms"] * 1e3,
                "push_back_path_plain_us": back["path_plain_ms"] * 1e3,
                "push_back_path_case_us": [x * 1e3 for x in back["path_case_ms"]],
                "push_back_path_active": back["path_active"],
            })
    log(f"phases (s): {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}"
        f"; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

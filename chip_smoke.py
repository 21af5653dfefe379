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
   its device time (cold L2), the byte bound for that data and the
   wrapper's stream time are measured;
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
   its plain version, timed with a cold L2 against that data's byte bound.

Each phase's wall time is printed. It then prints a ``{"kernels": [...]}``
line, the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. It imports nothing of JAX or of the JAX package.
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
# Each kernel's design: "pr1", the first one-thread-per-host kernel, or the
# redesign that computes the whole public function in one launch
# (csrc/popk.cu), named by the change that made it.
DESIGN = {"pop": "pr2", "push": "pr2", "obox": "pr3"}
# Kernel-check shapes (C event slots, P outbox slots, H hosts): the PHOLD
# bench's and the net model's filexfer16k. The phase-3 helpers read the
# module's C, P, H; ``use_shape`` sets them.
BENCH_SHAPE = (48, 24, 65536)
NET_SHAPE = (512, 64, 16384)
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


def use_shape(shape) -> None:
    global C, P, H
    C, P, H = shape


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


def device_ops(run, attempts: int = 3) -> list:
    """(name, count, device µs) of each device operation that
    ``torch.profiler`` (CUPTI) records while ``run()`` runs; ``run`` ends
    with a synchronise, and is padded with 20 ms of idle on each side, so
    that no launch sits at an edge of the capture window. CUPTI now and
    then hands back fewer device records than the run made (once none at
    all, once 3 and then 2 of 5; the cause is not known): a trace with
    none is taken again here, up to ``attempts`` times, and callers that
    count launches allow for a short one."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            run()
            time.sleep(0.02)
        ops = [(e.key, e.count, e.self_device_time_total)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.count > 0]
        if ops:
            return ops
    raise AssertionError(f"torch.profiler recorded no device operation in "
                         f"{attempts} traces")


def device_ms(fn, reset, *, kernel: str, reps=20, inner=10) -> float:
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
    total_us, n = 0.0, 0
    for name, count, us in device_ops(run):
        if kernel in name:
            total_us += us
            n += count
    # CUPTI now and then drops an activity record: average over the
    # launches it saw, and require nearly all of them.
    require(0.9 * reps * inner <= n <= reps * inner,
            f"profiler saw {n} {kernel} launches, expected {reps * inner}")
    return total_us / n / 1e3


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
    first 4,096 hosts (128 whole 32-host tiles) idle."""
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import NP

    mask = g.random(H) < mask_p
    time_ = 10**9 + g.integers(0, 5000, H)
    if edge:
        mask[:4096] = False
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
    first 4,096 hosts (128 whole 32-host tiles) idle; departures at
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
            require(not bool(got[1][:4096].any()) and bool(got[1].any()),
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
        exp = ct.tiled_filexfer_experiment(
            **gold["build"]["tiled_filexfer_experiment"])
    else:
        exp = ct.experiment_from_arrays(gold["experiment"])
    sha = hashlib.sha256(json.dumps(ct.experiment_arrays(exp),
                                    sort_keys=True).encode()).hexdigest()
    require(sha == gold["experiment_sha256"],
            f"{name}: the experiment built here is not the golden's")
    return exp


def run_net_golden(name: str, dev, *, count: bool = False) -> dict:
    """Run a net golden's experiment with state_digest=1 through
    Engine(device=dev) and compare: every digest word (the first differing
    (window, subsystem) is named), every Metrics field, the summary totals
    and the SHA-256 of each per-host summary array."""
    import numpy as np
    import torch

    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    gold = net_golden(name)
    exp = net_experiment(name, gold)
    windows = gold["windows"]
    params = EngineParams(**gold["params"], metrics_ring=windows,
                          state_digest=1)
    eng = Engine(exp, params, device=dev)
    torch.cuda.synchronize()
    if count:
        for k in popk.LAUNCHES:
            popk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    st = eng.run(n_windows=windows)
    metrics = Engine.metrics_dict(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES) if count else None
    fields = gold["digest_fields"]
    rows = drain_ring(st, eng.window)
    require(len(rows) == windows, f"{name}: {len(rows)} ring rows")
    for w, (want, row) in enumerate(zip(gold["digests"], rows)):
        for f, x in zip(fields, want):
            if row[f] != x:
                raise AssertionError(
                    f"{name}: first differing digest word: window {w}, "
                    f"subsystem {f.removeprefix('dg_')}: golden {x}, port "
                    f"{row[f]}")
    diff = {k: (gold["metrics"][k], v) for k, v in metrics.items()
            if gold["metrics"].get(k) != v}
    require(not diff and set(metrics) == set(gold["metrics"]),
            f"{name}: metrics differ from the JAX golden (golden, port): "
            f"{diff}")
    summ = eng.model_summary(st)
    got = {"total_rx_bytes": int(summ["total_rx_bytes"]),
           "total_flows_done": int(summ["total_flows_done"]),
           "nic_tx_bytes": int(summ["nic_tx_bytes"].sum()),
           "nic_rx_bytes": int(summ["nic_rx_bytes"].sum())}
    require(got == gold["summary"], f"{name}: summary {got} differs from "
            f"the JAX golden's {gold['summary']}")
    for k, want in gold["sha256"].items():
        h = hashlib.sha256(np.asarray(summ[k], "<i8").tobytes()).hexdigest()
        require(h == want, f"{name}: per-host {k} differs from the golden")
    return dict(wall_s=wall, events=metrics["events"],
                rounds=metrics["rounds"], windows=metrics["windows"],
                hosts=exp.n_hosts, launches=launches)


class NetPathCapture:
    """Hooks around the net path's call sites of the kernels' wrappers:
    ``engine.pop_until``, ``popk.push_local`` (``engine.push_local_event``
    imports it at each call, so TCP timers, transmit resumes and app
    wakeups all pass here) and ``tcp.outbox_append`` (every TCP segment).
    In window ``NET_PATH_WINDOW`` every round's pop arguments are cloned
    before the call, and so are the push and outbox arguments of the
    round's call that masks the most hosts; when a round ends it is kept
    if it is the busiest so far (most hosts popped), the sparsest with any
    pop, or the closest to half the busiest. Calls pass through unchanged."""

    def __init__(self):
        self.kept = {}
        self.cur = None
        self._until, self._window = None, -1
        self._saved = []

    def _end_round(self):
        rec, self.cur = self.cur, None
        if rec is None or rec["n"] == 0:
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

        def pop_hook(buf, until, extract="sum"):
            self._end_round()
            if until is not self._until:  # win_end: one tensor per window
                self._until, self._window = until, self._window + 1
            if self._window != NET_PATH_WINDOW:
                return pop(buf, until, extract)
            args = self._clone_args((buf, until))
            out = pop(buf, until, extract)
            self.cur = {"n": int(out[1].mask.sum()), "pop": (0, args)}
            return out

        def push_hook(buf, mask, time_, kind, p):
            self._widest("push", (buf, mask, time_, kind, p))
            return push(buf, mask, time_, kind, p)

        def obox_hook(ob, mask, dst, kind, depart, p):
            self._widest("obox", (ob, mask, dst, kind, depart, p))
            return obox(ob, mask, dst, kind, depart, p)

        self._saved = [(engine, "pop_until", pop), (popk, "push_local", push),
                       (tcp, "outbox_append", obox)]
        engine.pop_until, popk.push_local = pop_hook, push_hook
        tcp.outbox_append = obox_hook
        return self

    def __exit__(self, *exc):
        self._end_round()
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


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
        "obox": (popk.outbox_append, popk.outbox_append_plain)}[name]
    ms, wrap_ms, nbytes, sector_bytes, err, active = [], [], [], [], 0, []
    for i, args in enumerate(cases):
        ref = plain(*args)
        got = wrapper(clone(args[0]), *args[1:])
        err = max(err, bit_equal(f"{name}[in path, case {i}]", ref, got))
        first = args[0]
        if name == "pop":
            nbytes.append(pop_bytes(first, args[1]))
            sector_bytes.append(pop_sector_bytes(first, args[1]))
            active.append(int(ref[1].mask.sum()))
        elif name == "push":
            nbytes.append(push_bytes(first, args[1], True))
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
                            kernel=f"{name}_kernel", reps=30, inner=1))
        restore(planes, saved)()
        wrap_ms.append(time_ms(call, restore(planes, saved)))
    n = len(cases)
    return dict(path_ms=sum(ms) / n, path_bytes=sum(nbytes) / n,
                path_wrapper_ms=sum(wrap_ms) / n, path_err=err,
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
        f"; wrapper call {r['path_wrapper_ms'] * 1e3:.2f} us); byte bound "
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

    kernels = []
    for name, r in checks.items():
        n = net_checks[name]
        err = max(r["max_abs_err"], r["path_err"], n["max_abs_err"],
                  n["path_err"])
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

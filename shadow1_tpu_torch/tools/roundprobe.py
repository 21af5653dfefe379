"""Round-path primitive ablation — where do the ms per round go? (port of
``tools/roundprobe.py``)

    python -m shadow1_tpu_torch.tools.roundprobe [probe ...] [--iters N]
        [--hosts H] [--cap C] [--check] [--device DEV]

Times the engine's round primitives in isolation, warm, as eager carried
loops (``carry = step(carry)`` ``--iters`` times, one device synchronise
at the end) carrying the buffer through the loop — the data dependence
the real round loop has — so the per-iteration cost attributes the ms per
round to a primitive instead of a shape microbenchmark. Each loop starts
from a fresh clone of its seeded carry (the CUDA kernels write the
planes in place), made before the clock starts, after a short warm-up
loop on another clone.

Probes (each prints µs per iteration):

* ``pop``      — ``popk.pop_until`` alone (the pop kernel)
* ``push``     — ``popk.push_local`` alone (the push kernel), then the
                 seeded kind plane copied back so the buffer never fills
                 (one more device op: the kernel writes in place)
* ``cycle``    — push then pop (the minimal self-sustaining round)
* ``wcycle``   — the same cycle while ``any_eligible`` (one synchronising
                 read an iteration: wcycle − cycle ≈ what the loop's
                 continue test costs)
* ``rng``      — the phold handler's two hash draws + exponential + randint
                 (the non-event-buffer half of a phold round)
* ``obox``     — ``popk.outbox_append`` alone (the obox kernel)
* ``phold_win``— the full phold window loop (``Engine.run``) over
                 ``min(--iters, WINDOWS)`` windows (200 at the default
                 iterations), the composite these primitives should sum
                 to
* ``deliver``  — ``events.deliver_batch`` of H packets (the per-window merge)

``pop_f``, ``push_f``, ``cycle_f`` and ``obox_f`` (the reference's
Pallas-kernel probes) name the same loops as ``pop``, ``push``, ``cycle``
and ``obox``: the port's pop, push and append ARE the kernels. The
reference's ``pop_nop`` and ``pop_gat`` (a pop without payload extraction,
a gather-extraction pop) and ``--pallas`` have no subject here — the port
has one pop, the kernel — and are refused (exit 2).

``--check`` also runs each kernel probe (pop, push, cycle, wcycle, obox)
with the kernels' plain PyTorch versions (``events.*_plain``,
``outbox.outbox_append_plain``) from the same seeded carry, on the same
device, and compares the final carries bit for bit (``bit_equal``;
``plain_us_per_iter`` beside). On the CPU the wrappers run the plain
versions themselves, so the check is trivially equal there.

``phold_win`` runs ``--iters`` windows as the reference's does, but at
most ``WINDOWS`` (200): an eager window dispatches hundreds of device
operations, so the reference's 5,000 windows would take minutes. Runs on
CUDA unless ``--device`` (or a function's ``device``) names another
device (``core/engine.py resolve_device``). One JSON line per probe, after a
header line with the backend, the shapes and, on CUDA, the card's name
and power limit. Compare ``pop + push`` against ``phold_win``'s per-round
cost: a large residual is round-loop structure (the handler's other ops,
the continue test's read), not the event primitives.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

PROBES = ("pop", "push", "cycle", "wcycle", "rng", "obox", "phold_win",
          "deliver")
# The reference's Pallas probes: the same loops here.
ALIASES = {"pop_f": "pop", "push_f": "push", "cycle_f": "cycle",
           "obox_f": "obox"}
# Probes that go through a kernel, and so have a plain twin for --check.
KERNEL_PROBES = ("pop", "push", "cycle", "wcycle", "obox")
REFUSED = {
    "pop_nop": "a pop without payload extraction has no subject in the "
               "port: its one pop is the CUDA kernel (csrc/popk.cu), which "
               "extracts kind, tie-break and payload in the same pass",
    "pop_gat": "a gather-extraction pop has no subject in the port: its "
               "one pop is the CUDA kernel (csrc/popk.cu)",
}
ITERS = 5000
HOSTS = 1000
CAP = 256
WINDOWS = 200
OBOX_CAP = 64
UNTIL = 1 << 30                 # the pop bound: everything seeded is eligible


def seeded_buf(n_hosts: int, cap: int, fill: int, rng, device=None):
    """A buffer with ``fill`` live events per host at random times (kind
    1), drawn from the numpy generator ``rng`` exactly as the reference's
    ``seeded_buf`` draws them: times in [0, 2**30) (under the i32 rebase
    horizon, epoch 0), tie-breaks in [0, 2**40)."""
    import torch

    from shadow1_tpu_torch.core import events as ev
    from shadow1_tpu_torch.core.engine import resolve_device

    device = resolve_device(device)
    buf = ev.evbuf_init(n_hosts, cap, device)
    t = torch.from_numpy(rng.integers(0, 1 << 30, (cap, n_hosts))).to(device)
    tb = torch.from_numpy(rng.integers(0, 1 << 40, (cap, n_hosts))).to(device)
    thi, tlo = ev.tb_split(t)
    hi, lo = ev.tb_split(tb)
    live = torch.arange(cap, device=device)[:, None] < fill
    buf = buf._replace(
        time_hi=torch.where(live, thi, buf.time_hi),
        time_lo=torch.where(live, tlo, buf.time_lo),
        tb_hi=torch.where(live, hi, buf.tb_hi),
        tb_lo=torch.where(live, lo, buf.tb_lo),
        kind=torch.where(live, 1, buf.kind),
    )
    return ev.rebase(buf, 0)


class Prims:
    """The primitives a probe's step calls: the wrappers (CUDA tensors go
    to the kernels, CPU tensors to the plain versions) or, with
    ``plain``, the plain versions on any device."""

    def __init__(self, plain: bool = False):
        from shadow1_tpu_torch.core import events as ev
        from shadow1_tpu_torch.core import outbox as ob
        from shadow1_tpu_torch.core import popk

        if plain:
            self.pop_until = ev.pop_until_plain
            self.push_local = ev.push_local_plain
            self.outbox_append = ob.outbox_append_plain
        else:
            self.pop_until = popk.pop_until
            self.push_local = popk.push_local
            self.outbox_append = popk.outbox_append


def event_rows(n_hosts: int, device):
    """(mask, kind, payload) of the push and append probes: every host, kind
    1, a zero payload."""
    import torch

    from shadow1_tpu_torch.consts import NP

    return (torch.ones(n_hosts, dtype=torch.bool, device=device),
            torch.ones(n_hosts, dtype=torch.int32, device=device),
            torch.zeros((NP, n_hosts), dtype=torch.int32, device=device))


def pop_step(buf, prims: Prims, until):
    """One pop; the popped times feed ``self_ctr`` so the results stay
    live (the buffer drains over the iterations)."""
    buf, p = prims.pop_until(buf, until)
    return buf._replace(self_ctr=buf.self_ctr + p.time)


def push_step(buf, prims: Prims, rows, kind0):
    """One push of every host at ``self_ctr + 1``, then the kind plane set
    back to ``kind0`` (in place: the kernel wrote it in place) so the
    buffer never fills."""
    m, k, pay = rows
    buf2, _over = prims.push_local(buf, m, buf.self_ctr + 1, k, pay)
    return buf2._replace(kind=buf2.kind.copy_(kind0))


def cycle_step(buf, prims: Prims, rows, until):
    """Pop, then push each popped event back 7 ns later."""
    m, k, pay = rows
    buf, p = prims.pop_until(buf, until)
    buf, _over = prims.push_local(buf, p.mask & m, p.time + 7, k, pay)
    return buf


def wcycle_loop(buf, prims: Prims, rows, n: int, until):
    """``cycle_step`` while some host has an eligible event and fewer than
    ``n`` iterations ran (the engine's continue test, one read each)."""
    from shadow1_tpu_torch.core.events import any_eligible

    r = 0
    while r < n and any_eligible(buf):
        buf = cycle_step(buf, prims, rows, until)
        r += 1
    return buf


def rng_step(ctr, key: int, hosts):
    """The phold handler's draws: exponential delay and random destination."""
    from shadow1_tpu_torch import rng as prng
    from shadow1_tpu_torch.consts import R_PHOLD_DELAY, R_PHOLD_DST

    delay = prng.exponential_ns(prng.bits(key, R_PHOLD_DELAY, hosts, ctr),
                                1e6)
    dst = prng.randint(prng.bits(key, R_PHOLD_DST, hosts, ctr),
                       hosts.shape[0])
    return ctr + 1 + (delay % 2) + dst.to(ctr.dtype)


def obox_step(box, prims: Prims, rows, dst):
    """One append per host at ``pkt_ctr + 7``, then ``cnt`` held so the
    outbox never saturates."""
    m, k, pay = rows
    box2, _ok = prims.outbox_append(box, m, dst, k, box.pkt_ctr + 7, pay)
    return box2._replace(cnt=box.cnt)


def deliver_step(buf, pkts):
    """``deliver_batch`` of one packet per host, then the occupancy held
    (the merged planes set back)."""
    from shadow1_tpu_torch.core.events import deliver_batch

    dst, t, tb, k, pay, m = pkts
    buf2, _over = deliver_batch(buf, dst, t, tb, k, pay, m)
    return buf2._replace(kind=buf.kind, time_hi=buf.time_hi,
                         time_lo=buf.time_lo, t32=buf.t32)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def carried_loop(step, carry0, iters: int, device, warm: int = 10):
    """(µs per iteration, final carry) of ``carry = step(carry)`` over
    ``iters`` iterations from a fresh clone of ``carry0``, after a warm-up
    loop of ``min(warm, iters)`` on another clone. ``step`` may also be a
    whole loop: ``step(carry, n)`` when it takes an iteration count
    (``wcycle``)."""
    from shadow1_tpu_torch.tools.phaseprobe import clone_tree

    def run(carry, n):
        for _ in range(n):
            carry = step(carry)
        return carry

    loop = getattr(step, "loop", None) or run
    loop(clone_tree(carry0), min(warm, iters))
    carry = clone_tree(carry0)
    _sync(device)
    t0 = time.perf_counter()
    carry = loop(carry, iters)
    _sync(device)
    return 1e6 * (time.perf_counter() - t0) / iters, carry


def probe_setup(name: str, n_hosts: int, cap: int, device, prims: Prims,
                seed: int = 7):
    """(step, carry0) of a probe other than ``phold_win``; the seeded data
    come from ``np.random.default_rng(seed)``, drawn afresh per probe."""
    import torch

    g = np.random.default_rng(seed)
    rows = event_rows(n_hosts, device)
    until = torch.tensor(UNTIL, dtype=torch.int64, device=device)
    if name == "pop":
        return ((lambda b: pop_step(b, prims, until)),
                seeded_buf(n_hosts, cap, cap, g, device))
    if name == "push":
        buf = seeded_buf(n_hosts, cap, cap // 2, g, device)
        kind0 = buf.kind.clone()
        return (lambda b: push_step(b, prims, rows, kind0)), buf
    if name == "cycle":
        return ((lambda b: cycle_step(b, prims, rows, until)),
                seeded_buf(n_hosts, cap, cap // 2, g, device))
    if name == "wcycle":
        def step(b):
            return cycle_step(b, prims, rows, until)
        step.loop = lambda b, n: wcycle_loop(b, prims, rows, n, until)
        return step, seeded_buf(n_hosts, cap, cap // 2, g, device)
    if name == "obox":
        from shadow1_tpu_torch.core.outbox import outbox_init

        dst = torch.ones(n_hosts, dtype=torch.int32, device=device)
        return ((lambda b: obox_step(b, prims, rows, dst)),
                outbox_init(n_hosts, OBOX_CAP, device))
    if name == "rng":
        from shadow1_tpu_torch import rng as prng

        key = prng.base_key(7)
        hosts = torch.arange(n_hosts, dtype=torch.int32, device=device)
        return ((lambda c: rng_step(c, key, hosts)),
                torch.zeros(n_hosts, dtype=torch.int64, device=device))
    if name == "deliver":
        def t(a, dtype):
            return torch.from_numpy(a).to(device=device, dtype=dtype)

        dst = t(g.integers(0, n_hosts, n_hosts), torch.int32)
        tt = t(g.integers(0, 1 << 40, n_hosts), torch.int64)
        tb = t(g.integers(0, 1 << 40, n_hosts), torch.int64)
        m, k, pay = rows
        buf = seeded_buf(n_hosts, cap, cap // 2, g, device)
        return (lambda b: deliver_step(b, (dst, tt, tb, k, pay, m))), buf
    raise ValueError(f"unknown probe {name!r}")


def run_probe(name: str, n_hosts: int = HOSTS, cap: int = CAP,
              iters: int = ITERS, device=None, plain: bool = False):
    """(µs per iteration, final carry) of one probe's carried loop."""
    from shadow1_tpu_torch.core.engine import resolve_device

    device = resolve_device(device)
    step, carry0 = probe_setup(name, n_hosts, cap, device, Prims(plain))
    return carried_loop(step, carry0, iters, device)


def carries_equal(a, b) -> bool:
    """Every tensor of two carries equal (dtype, shape and values)."""
    from shadow1_tpu_torch.convert import flatten_like_jax

    la, lb = flatten_like_jax(a), flatten_like_jax(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all())
        for x, y in zip(la, lb))


def phold_win(n_hosts: int = HOSTS, cap: int = CAP, iters: int = ITERS,
              device=None, metrics_ring: int = 0,
              state_digest: bool = False) -> dict:
    """The full phold window loop: 10 warm windows, then
    ``min(iters, WINDOWS)`` timed."""
    from shadow1_tpu_torch.config.compiled import single_vertex_experiment
    from shadow1_tpu_torch.consts import MS, EngineParams
    from shadow1_tpu_torch.core.engine import Engine, resolve_device

    windows = min(iters, WINDOWS)

    exp = single_vertex_experiment(
        n_hosts=n_hosts, seed=77, end_time=10**15, latency_ns=30 * MS,
        model="phold",
        model_cfg={"mean_delay_ns": float(60 * MS), "init_events": 4},
    )
    ring = metrics_ring or (256 if state_digest else 0)
    eng = Engine(exp, EngineParams(ev_cap=cap, metrics_ring=ring,
                                   state_digest=int(state_digest)),
                 device=resolve_device(device))
    held = [eng.run(eng.init_state(), n_windows=10)]  # warm state
    eng.synchronize()
    m0 = Engine.metrics_dict(held[0])
    t0 = time.perf_counter()
    st1 = eng.run(held.pop(), n_windows=windows)
    eng.synchronize()
    wall = time.perf_counter() - t0
    m1 = Engine.metrics_dict(st1)
    rounds = m1["rounds"] - m0["rounds"]
    return {"probe": "phold_win", "windows": windows,
            "us_per_window": round(1e6 * wall / windows, 1),
            "rounds_per_window": round(rounds / windows, 2),
            "us_per_round": round(1e6 * wall / max(rounds, 1), 1),
            "events": m1["events"] - m0["events"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.roundprobe")
    ap.add_argument("probes", nargs="*", default=list(PROBES))
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--hosts", type=int, default=HOSTS)
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--check", action="store_true",
                    help="also run each kernel probe with the plain "
                         "versions and compare the final carries")
    ap.add_argument("--pallas", action="store_true",
                    help="refused: the port has no Pallas path (its pop, "
                         "push and append are the CUDA kernels)")
    ap.add_argument("--metrics-ring", type=int, default=0,
                    help="phold_win probe: run with a W-deep telemetry "
                         "ring (the ring-write cost per window)")
    ap.add_argument("--state-digest", action="store_true",
                    help="phold_win probe: run with the per-window state "
                         "digests on (implies a ring)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu to run on the "
                         "CPU)")
    args = ap.parse_args(argv)

    if args.pallas:
        print(json.dumps({"error": "--pallas has no subject in the port: "
                                   "pop, push and the outbox append always "
                                   "run the CUDA kernels on the card"}))
        return 2
    for p in args.probes:
        if p in REFUSED:
            print(json.dumps({"error": f"probe {p!r} refused: {REFUSED[p]}"}))
            return 2
        if ALIASES.get(p, p) not in PROBES:
            print(json.dumps({"error": f"unknown probe {p!r}",
                              "probes": list(PROBES)}))
            return 2

    from shadow1_tpu_torch.core.engine import resolve_device
    from shadow1_tpu_torch.tools.perfprobe import card_line

    dev = resolve_device(args.device)
    card = card_line(dev)
    H, C, iters = args.hosts, args.cap, args.iters
    print(json.dumps({"backend": dev.type, "hosts": H, "cap": C,
                      "iters": iters, **({"card": card} if card else {})}),
          flush=True)
    for probe in args.probes:
        name = ALIASES.get(probe, probe)
        if name == "phold_win":
            row = phold_win(H, C, iters, dev, args.metrics_ring,
                            args.state_digest)
            print(json.dumps(row), flush=True)
            continue
        us, carry = run_probe(name, H, C, iters, dev)
        row = {"probe": probe, "us_per_iter": round(us, 1)}
        if args.check and name in KERNEL_PROBES:
            plain_us, ref = run_probe(name, H, C, iters, dev, plain=True)
            row.update(plain_us_per_iter=round(plain_us, 1),
                       bit_equal=carries_equal(carry, ref))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

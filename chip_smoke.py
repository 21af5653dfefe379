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
   (``configs/rung2_tgen100.yaml``) with compaction off for its first
   ``RUNG2_PLAIN_WINDOWS`` windows (their digest words held) and with
   ``compact_cap`` 48 for all 150 (windows on both sides of the bucket
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
14. the recovery planes on ``fidelity16k`` at full width, held to
   ``net_fidelity16k.json`` (overflow-free runs are cap-independent):
   (1) pop, push (``push_local``, ``push_back``, a full buffer's overflow
   flag) and obox against their plain versions at the ladder caps C = 24,
   32 and 64 (H = 16,384), timed against the byte bound (run after phase
   10's kernel checks, while ``torch.profiler``'s traces are whole); (2)
   a run from
   ``ev_cap`` 24 under ``txn.OverflowGuard(mode="retry")`` in chunks of 2
   windows (its launches counted from 0: the phase's main path), whose
   every rollback copy must share no storage with the state the chunk
   runs on; (3) the same under ``halt``: ``CapacityExceededError`` at the
   chunk the retry replayed, its fields checked; (4) a run from the
   golden's ``ev_cap`` under ``tune.CapController`` (a retry guard
   attached) with ``selfcheck``, which must shrink; (5) ``mem.estimate``:
   the resident bytes within 10 % of ``torch.cuda.memory_allocated``
   after ``init_state`` (fidelity16k at ``ev_cap`` 512 and 24, tgen50k)
   and the peak at or above the ``max_memory_allocated`` of runs (2) and
   (4); (6) a pre-flight budget (``SHADOW1_MEM_BYTES``) between the retry
   and halt peaks downshifts retry to halt, and that run, signaled
   (``SHADOW1_OBS_SIGTERM_SELF_AT_NS``) at the window-4 boundary under a
   ``DrainHandler``, stops with ``PreemptedExit`` after committing the
   in-flight chunk and writing its snapshot; a fresh ``Engine`` resumes it
   to the golden's end; (7) a per-process memory fraction that makes
   ``init_state`` fail: ``mem.is_oom`` must classify the allocator's
   error. Each step's wall time is printed.
15. the fleet (``fleet/``; run right after phase 14's step 1, while the
   profiler's traces are whole), four steps, each step's wall time
   printed: (1) the 17-lane ``sweep_phold_experiments`` (the 4 seeds of
   ``configs/sweep_phold.yaml`` under each of its 4 variants, and one
   lane held to 2 rounds a window) as one ``FleetEngine``, its launches
   counted from 0, every lane's metrics, digest words and per-host hops
   equal to ``golden/fleet_sweep_phold.json`` (the JAX ``FleetEngine``'s),
   and pop's per-host bound (the capped lane's columns held) bit-equal to
   ``pop_until_plain``; (2) ``fleet_filexfer16k``: filexfer16k and its
   seed 2, 3 and 4 variants at 0.1 %, 1 % and 2 % loss as one fleet of
   65,536 host columns, 10 windows, the main path's launches counted from
   0 — lane 0's digest words equal to ``net_filexfer16k.json``'s windows
   0-9, every lane's metrics, ring rows and summaries equal to the port's
   solo ``Engine`` on the card; it prints the wall time, ms per round,
   rounds per window, aggregate events/s, the four solo runs' summed wall,
   device operations and device→host reads per round counted on the
   fleet's own windows 10-12 as its run goes on (``CountedWindows``; lane
   0 solo's ops on its window 10), and ``mem.estimate`` against
   ``memory_allocated`` after ``init_state`` (within 10 %) and against
   the run's ``max_memory_allocated`` (at or above it); (3) the three
   kernels on the arguments of three rounds of that fleet's window 8
   (the hooks of phase 8), bit-equal to their plain versions and timed
   against the byte bound; (4) on the sweep, each equal to the golden: a
   run from ``ev_cap`` 4 under ``--on-overflow
   retry``, a halt whose error names the lane and its seed, a
   ``--on-lane-fail quarantine`` of a lane forced to fail (a self-check
   violation) whose 16 survivors stay equal, a window-10 snapshot resumed
   in a fresh ``FleetEngine``, and the capped lane sliced there and
   resumed in a solo ``Engine``.

16. the serve plane (``serve/``; run right after phase 15), two steps,
   each step's wall time printed: (a) an in-process ``ServeDaemon`` on
   the card (``ckpt_every_s`` 1e9, driven through ``step()``) serves
   ``configs/dense_tgen50k.yaml``, submitted through the client as JSON
   text (``TGEN50K_DOC``: 50,000 hosts, 200 ms, the digest words on), for
   seeds 71 and 72: one 2-lane batch of 100,000 host columns, its
   launches counted from 0 (the main path). The daemon's seed-71
   experiment must hash to ``net_tgen50k.json``'s ``experiment_sha256``
   and its 20 ring rows and metrics equal the golden's; seed 72's rows
   and metrics must equal a solo ``Engine`` run on the card; the three
   kernels, on the arguments of three rounds of window
   ``SERVE_PATH_WINDOW`` (the hooks of phase 8), bit-equal to their plain
   versions and timed against the byte bound; the idle budget must not
   shrink while the batch is resident. Seeds 72 and 71 resubmitted (the
   lanes swap) must hit the cache (the same engine, no ``FleetEngine``
   built) and give the batch-1 streams. It prints the batch wall, ms per
   round and aggregate events/s against the solo run, device ops and
   reads per round counted on windows 10-12 of the swapped batch and of
   the solo run (``CountedWindows``; the solo run's timing leaves them
   out), build
   against rebind seconds, the snapshots ``run_fleet`` wrote at batch
   end and their seconds, and the memory estimate against
   ``memory_allocated`` (resident) and the swapped batch's
   ``max_memory_allocated`` (peak), and what stays allocated between the
   two batches must be no more than the cached engine's ctx tables (the
   estimate's ``const``) and ``LEFTOVER_SLACK``; (b) ``tools/serveprobe.py`` with
   ``--resilience`` and an over-budget config (JSON mirrors
   of ``configs/serve_phold.yaml`` and ``configs/mem_overbudget.yaml``)
   against ``python -m shadow1_tpu_torch serve`` and ``submit``
   subprocesses on the card: round trip, cache hits, admission
   (EXIT_MEMORY before any build), SIGTERM (EXIT_SERVE_SHUTDOWN),
   waiting_headroom, queue_full, a queue TTL, an injected transient crash,
   a priority-1 eviction and a restart on a drained spool, every served
   stream equal to the port's solo CLI run.

17. the operator tools (``shadow1_tpu_torch/tools/``; run last), on JSON
   mirrors of the YAML configs (``tool_configs``), each step's wall time
   printed: (b, first) ``memprobe.maxfit`` at the card's budget
   (``mem.device_budget``) for fidelity16k and the 17-lane sweep; (a)
   ``faultprobe sort0 scan0 pop phold tor 10`` as a subprocess, alone:
   its first line must name ``cuda``, every probe report ok and launch
   its kernels; its ``pop`` probe, in process, bit-equal to
   ``push_local_plain`` / ``pop_until_plain`` on the same inputs; it
   prints the PHOLD probe's ms per round; (c) three ``chaosprobe``
   subprocesses side by side, each running its trials at once after its
   straight run (``--jobs``) — solo on rung1, 4 trials (``drain``,
   ``torn_head``, ``corrupt_head`` and ``mid_write``; 40 windows, the
   straight stream equal to ``net_rung1.json``'s windows 0-39
   and cross-checked against ``--engine cpu``, the numpy oracle:
   ``"oracle_checked": true``), the 17-lane sweep under ``--fleet
   --extra "--on-overflow retry"`` from ``ev_cap`` 4 (2 trials: ``drain``,
   ``torn_head``), and ``--serve 1`` on serve_phold — each verdict ok;
   beside them the memory run, the CLI on rung1 under ``--on-overflow
   retry --on-oom downshift`` with ``SHADOW1_MEM_BYTES`` between its halt
   and retry peaks; meanwhile, in process, (b)
   ``memprobe.audit_experiment`` of fidelity16k and ``audit_config`` of
   dense_tgen50k within 10 %, and ``memprobe.subbatch_run`` on the sweep
   (batches of 9, each through a snapshot; its launches counted from 0)
   bit-identical and every lane equal to
   ``golden/fleet_sweep_phold.json``; then (d) heartbeat_report,
   flowreport, netreport and captune over record streams the program
   wrote on the card — phase 13's split run (``OBS_RECORDS``), the solo
   chaosprobe's CLI launches, the memory run and phase 16's daemon
   (``serve.log``): each exits 0, and the lineage, memory, serve, flow
   and link sections are there and not empty.

18. the oracle and the comparator (``cpu_engine/``, ``native/`` and the
   tools on them; run last), three steps, each step's wall time printed:
   (a) the C++ thread-per-core comparators, built with g++ from the
   checkout's sources in threads started with the script (a failed build
   fails the phase), on bench PHOLD (``os.cpu_count()`` threads and
   ``NATIVE_THREADS``) and on ``filexfer16k``, ``tgen50k``, ``tor10k``
   and ``bitcoin5k`` built in code from the goldens: their counters equal
   to the goldens (and, for PHOLD, to the CUDA bench run); each
   comparator's wall and events/s printed beside the CUDA engine's run of
   the same config and windows in this call, and the host's CPU model and
   core count; (b) the host-only work, run in a process of its own (no
   CUDA device visible) from the end of phase 2 on, beside the card
   phases (``OracleHostWork``): the numpy oracle at full width with the
   digest words on, ``tor10k`` (40 windows) and ``bitcoin5k`` (60): every
   Metrics field it keeps, every summary sum and per-host SHA-256 and
   every digest word equal to the golden; the CLI's ``--engine cpu`` on
   rung1 (40 windows), its stderr digest rows held here to phase 7's CUDA
   ring rows; ``pcapdump`` on rung1 (one ``--host``, one ``--edge``: each
   file's SHA-256), ``activeprobe`` and ``depthprobe`` on tor10k's
   mirror, each against the JAX package's rows in
   ``golden/oracle_tools.json`` (``tools/torch_golden.py``); (c) the
   tools on the card, in process, on JSON mirrors (``oracle_configs``),
   against the same golden: ``fleetprobe`` (``FLEETPROBE_RUNS``: the
   4-lane sweep against its solo runs on the card and on the oracle, the
   same sweep under ``--retry``, and phase 17's 17-lane sweep under
   ``--retry``) and ``occprobe`` on dense_tgen50k at its full width, each
   with its launches counted from 0 and every kernel launched.

19. the sharded engine (``shard/``; run last), three steps, each step's
   wall time printed, after reading the card's compute mode: (a) tor10k
   at its full width through a ``ShardedEngine`` in a world of one rank
   (NCCL, in this process), its launches and exchanges counted from 0
   and every kernel launched, equal to ``golden/net_tor10k.json`` in
   every metric (``rounds`` included), summary and digest word, its
   ``x2x_max_fill`` and ms per round printed beside the solo engine's on
   the same windows in this call; (b) unless the card is in
   ``Exclusive_Process`` mode (then printed, and not run), 2 gloo ranks
   on the one card (one spawned group, ``shard2_rank``): filexfer16k's
   20 windows at 8,192 columns each, equal to
   ``golden/shard2_filexfer16k.json`` (the JAX ``ShardedEngine`` over 2
   devices) and, but for the per-shard counters, to
   ``net_filexfer16k.json``; rank 0 holds the three kernels to their
   plain versions on window ``NET_PATH_WINDOW``'s arguments, timed; then
   the reference's convergent case on 8 gloo ranks (``convergent_rank``:
   at 2 ranks the auto cap is already the full cap): the auto cap's
   retry fires and equals the full-cap run and the solo engine, and the
   auto cap set explicitly raises; (c) beside (b), subprocesses on JSON
   mirrors (``shard_configs``): ``paritytrace rung1 tpu sharded:1``
   (identical) and with ``--inject 5:rng`` (exit 3, naming (5, rng)),
   ``churnprobe churn --sides cpu,tpu,sharded:1`` (ok, accounting
   closed; its oracle side in a process of its own), ``torchrun
   --nproc-per-node 1 -m shadow1_tpu_torch rung1 --engine sharded``
   against the solo CLI's result line, and ``crossover --hosts
   2000,10000``.

20. perfprobe and benchgate (``tools/perfprobe.py``, ``tools/benchgate.py``;
   run last), two steps, each step's wall time printed: (a) perfprobe's
   four shape ablations at ``PERFPROBE_HOSTS`` (filexfer16k's width)
   through ``perfprobe.probes`` and ``time_engine`` (warm 20, measure 40
   windows), each with its launches counted from 0 and every kernel
   launched, none overflowing, the three filexfer probes equal in events
   and rounds per window (they differ only in shapes); it prints each row,
   the socket axis (``fx_s64`` − ``fx_s8``) and the FIFO axis (``fx_mq64``
   − ``fx_s64``) in ms per round, and fx_mq64's peak allocated bytes
   beside its ``mem.estimate``; (b) beside (a), ``benchgate --update`` into
   a temporary copy of the committed baseline, in a subprocess: each row's
   ``events``, ``hosts``, ``experiments``, ``chunk_windows`` and
   ``chunks_timed`` equal to ``golden/benchgate_rows.json`` (the JAX
   package's rows on the CPU), then each row gated against the committed
   ``cuda`` entry and the verdict printed — a timing verdict, ``failed``
   included, does not fail the phase.

21. the performance-attribution plane (``tools/{opcensus,phaseprobe,
   roundprobe,popprof}.py``; run last, but for steps (a) and (b)), four
   steps, each step's wall time printed: (a) run in this process while the
   golden runs' processes work (it counts, and times nothing):
   ``opcensus`` on smoke and rung1 (its JSON mirror) on CUDA, twice: the two runs equal key by key (ops, reads,
   launches, the counted window), a pop one launch of its kernel;
   ``--inject 60`` adds 60 ops after every round of ``rounds`` and
   nothing elsewhere, and the gate's failures name ``rounds`` alone; the
   verdict against the committed ``cuda`` entry is printed (a drift does
   not fail the phase); the CPU census, run in phase 18's host process,
   has the card's reads and window (its own verdict printed); (b) run
   right after the ladder-cap kernel checks, while the profiler's records
   are whole: ``opcensus``'s launch census (``--fusion``) of rung1, each
   window phase in a ``torch.profiler`` capture of its own, whose
   launches of the three kernels equal the phase's ``popk.LAUNCHES``
   delta (a phase is captured again, up to 3 times, when short); (c)
   ``phaseprobe`` on smoke (16 windows after 8) and rung1 (2 windows
   after 8), the staged run's metrics equal to the straight run's and
   coverage at least 0.9, and one ``--device-trace`` of smoke holding
   the four phase spans and the three kernels; (d) after (c), nothing
   beside it: ``roundprobe``'s probes at their defaults (H
   1,000, C 256, 5,000 iterations; ``phold_win`` 200 windows) and
   ``popprof``'s grid (C 256 and 64), each kernel loop's final carry bit
   equal to the same loop through the plain versions.

The golden runs of phases 7, 9 and 11 time nothing against a bound: they
run as four processes side by side (``GoldenWorkers``, ``GOLDEN_GROUPS``),
after phase 16 and before phase 8, and their checks follow in this
process. The path phases (8, 10, 12) rerun a golden only to one window
past the window whose arguments they keep (``run_net_golden(stop_after=)``:
the digest words of those windows are compared).

Each phase's wall time is printed, and the whole script's. It then prints a ``{"kernels": [...]}``
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
# rung2's run with compaction off stops after this many windows (of 150).
RUNG2_PLAIN_WINDOWS = 40
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
                launches=launches, metrics=metrics)


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
                   compact_cap: int | None = None,
                   stop_after: int | None = None) -> dict:
    """Run a net golden's experiment with state_digest=1 through
    Engine(device=dev) and compare: every digest word (the first differing
    (window, subsystem) is named), every Metrics field, the summary
    entries (each summed over hosts) and the SHA-256 of each per-host
    summary array. ``compact_cap`` overrides the golden's (compaction is
    bit-identical, so one golden serves both); the windows each branch of
    ``compact_window_rounds`` ran are returned. With ``stop_after`` the
    run stops after that many windows and only the digest words of those
    windows are compared (the path phases rerun a golden for one
    window's kernel arguments)."""
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
    st = eng.run(st, n_windows=stop_after or windows)
    metrics = Engine.metrics_dict(st)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES) if count else None
    entries = dict(popk.PUSH_ENTRIES) if count else None
    rows = drain_ring(st, eng.window)
    if stop_after is not None:
        check_digests(name, gold, rows, 0, stop_after)
        got = None
    else:
        got = check_net_golden(name, gold, eng, st, rows)
    return dict(wall_s=wall, events=metrics["events"], rows=rows,
                rounds=metrics["rounds"], windows=metrics["windows"],
                hosts=exp.n_hosts, launches=launches, push_entries=entries,
                init_push=init_push if count else None, metrics=metrics,
                compact_windows=dict(compact.WINDOWS), summary=got)


def check_net_golden(name: str, gold: dict, eng, st, rows,
                     first: int = 0, skip=()) -> dict:
    """Hold a net run to its golden: the ring ``rows`` of windows ``first``
    on (every digest word; the first differing (window, subsystem) is
    named), every Metrics field but those in ``skip``, the summary
    entries (each summed over hosts) and the SHA-256 of each per-host
    summary array. Returns the summary sums."""
    import numpy as np

    from shadow1_tpu_torch.core.engine import Engine

    check_digests(name, gold, rows, first, gold["windows"])
    metrics = Engine.metrics_dict(st)
    diff = {k: (gold["metrics"][k], v) for k, v in metrics.items()
            if gold["metrics"].get(k) != v and k not in skip}
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


def check_digests(name: str, gold: dict, rows, first: int, last: int) -> None:
    """The ring ``rows`` are windows ``first`` to ``last`` (exclusive) and
    their digest words equal the golden's; the first differing (window,
    subsystem) is named."""
    fields = gold["digest_fields"]
    rows = [r for r in rows if r["type"] == "ring"]
    require(len(rows) == last - first,
            f"{name}: {len(rows)} ring rows for windows {first}-{last - 1}")
    for w, (want, row) in enumerate(zip(gold["digests"][first:last], rows),
                                    start=first):
        require(row["window"] == w, f"{name}: ring row {row['window']} "
                f"where window {w} was due")
        for f, x in zip(fields, want):
            if row[f] != x:
                raise AssertionError(
                    f"{name}: first differing digest word: window {w}, "
                    f"subsystem {f.removeprefix('dg_')}: golden {x}, port "
                    f"{row[f]}")


# The golden runs of phases 7, 9 and 11 (``golden_jobs``) time nothing
# against a bound: they run as processes side by side, each one host thread
# driving the card (idle most of a round), grouped to about equal walls
# (PR 12's whole runs on the card: churn8 136-163 s, rung2 compacted
# 119-145 s, filexfer16k with rung1 92-111 s, the rest 100-120 s).
GOLDEN_GROUPS = (("churn8",), ("rung2/compact48",), ("filexfer16k", "rung1"))


def golden_jobs() -> list:
    """(label, golden, run_net_golden keywords) of phases 7, 9 and 11."""
    jobs = [("filexfer16k", "filexfer16k", dict(count=True)),
            ("rung1", "rung1", {})]
    for name in APP_RUNS:
        for cap in net_golden(name).get("compact_caps", [None]):
            # rung2's full-width run stops early (its digest words are
            # held); the compacted run goes the whole horizon.
            jobs.append((name if not cap else f"{name}/compact{cap}", name,
                         dict(count=True, compact_cap=cap,
                              stop_after=(RUNG2_PLAIN_WINDOWS
                                          if name == "rung2" and not cap
                                          else None))))
    return jobs + [(name, name, dict(count=True)) for name in FID_RUNS]


def golden_worker(labels: list, out_path: str) -> None:
    """Run the golden jobs ``labels`` on the card in this process
    (``GoldenWorkers``); write their results, or the error, to
    ``out_path``."""
    import traceback

    import torch

    from shadow1_tpu_torch.core import _build

    try:
        _build.library()
        jobs = {label: (name, kw) for label, name, kw in golden_jobs()}
        res = {}
        for label in labels:
            name, kw = jobs[label]
            res[label] = run_net_golden(name, torch.device("cuda"), **kw)
    except BaseException:  # noqa: BLE001 — reported to the parent
        res = {"error": traceback.format_exc()}
    Path(out_path).write_text(json.dumps(res, default=int))


class GoldenWorkers:
    """``golden_worker`` processes, one per group of ``GOLDEN_GROUPS`` and
    one for the other jobs, started together; ``join`` waits for them all
    and returns label → result (``run_net_golden``'s), raising the first
    error."""

    def __init__(self):
        labels = [label for label, _, _ in golden_jobs()]
        grouped = {label for group in GOLDEN_GROUPS for label in group}
        groups = list(GOLDEN_GROUPS) + [
            tuple(x for x in labels if x not in grouped)]
        out = ROOT / "build" / "chip_smoke_golden"
        out.mkdir(parents=True, exist_ok=True)
        self.procs = []
        for i, group in enumerate(groups):
            path = out / f"w{i}.json"
            path.unlink(missing_ok=True)
            self.procs.append((path, subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; "
                 f"chip_smoke.golden_worker({list(group)!r}, "
                 f"{str(path)!r})"], cwd=ROOT, stdout=subprocess.DEVNULL)))

    def kill(self) -> None:
        for _, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def join(self, timeout: float = 900) -> dict:
        deadline = time.perf_counter() + timeout
        res = {}
        try:
            for path, proc in self.procs:
                rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
                require(rc == 0 and path.exists(),
                        f"golden worker {path.name} exited {rc}")
                got = json.loads(path.read_text())
                require("error" not in got, f"golden worker {path.name}: "
                        f"{got.get('error', '')[-3000:]}")
                res.update(got)
        finally:
            self.kill()
        return res


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
# The record stream of phase 13's split run, for phase 17's reports.
OBS_RECORDS = ROOT / "build" / "chip_smoke_records" / "obs.jsonl"
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


def hb_records(hb) -> list:
    """A ``run_with_heartbeat`` heartbeat's stream: its heartbeats, then
    the ring, flow and link records it drained."""
    return hb.records + hb.ring_records + hb.flow_records + hb.link_records


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
    from shadow1_tpu_torch.convert import clone_state
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
    OBS_RECORDS.parent.mkdir(parents=True, exist_ok=True)
    OBS_RECORDS.write_text("".join(
        json.dumps(r) + "\n" for r in hb_records(hb1) + hb_records(hb2)))
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
    from shadow1_tpu_torch.convert import clone_state
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
    from shadow1_tpu_torch.convert import clone_state
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


# -- phase 14: the recovery planes --------------------------------------------

REC_DIR = ROOT / "build" / "chip_smoke_recovery"
# The ladder caps a retried or resized fidelity16k run reaches (P and H of
# fidelity16k).
LADDER_CAPS = (24, 32, 64)
REC_START_CAP = 24
# Chunks of the recovery runs (windows); the drain run is signaled at the
# boundary of window DRAIN_AT, so it stops one chunk later.
REC_CHUNK, DRAIN_AT = 2, 4


def fid_params(gold: dict, **kw):
    """fidelity16k's params with the ring and the digest words."""
    from shadow1_tpu_torch.consts import EngineParams

    return EngineParams(**{**gold["params"], "metrics_ring": gold["windows"],
                           "state_digest": 1, **kw})


def zero_counts() -> None:
    from shadow1_tpu_torch.core import popk

    for counts in (popk.LAUNCHES, popk.PUSH_ENTRIES):
        for k in counts:
            counts[k] = 0


def read_counts() -> dict:
    from shadow1_tpu_torch.core import popk

    return {**popk.LAUNCHES, **popk.PUSH_ENTRIES}


def clean_allocator(dev) -> int:
    """Free what nothing holds, reset the peak; the bytes still allocated."""
    import gc

    import torch

    gc.collect()
    sync(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def measured_peak(dev, base: int) -> dict:
    import torch

    sync(dev)
    return {"allocated": torch.cuda.max_memory_allocated(dev) - base,
            "reserved": torch.cuda.max_memory_reserved(dev)}


def recovery_kernels(g, dev) -> dict:
    """Step 1: pop, push (push_local and push_back, a full buffer's
    overflow flag included) and obox against their plain versions at the
    ladder caps, H = 16,384, timed against the byte bound."""
    out = {}
    for c in LADDER_CAPS:
        use_shape((c, NET_SHAPE[1], NET_SHAPE[2]))
        out[c] = {"pop": check_pop(g, dev), "push": check_push(g, dev),
                  "obox": check_obox(g, dev)}
    use_shape(BENCH_SHAPE)
    return out


def recovery_retry(dev, gold, exp) -> dict:
    """Step 2: fidelity16k from ev_cap REC_START_CAP under
    ``on_overflow=retry`` in chunks of REC_CHUNK windows, held to the
    golden. Every rollback point must share no storage with the state the
    chunk then runs on; each clone is timed."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry.ring import drain_ring
    from shadow1_tpu_torch.txn import OverflowGuard

    base = clean_allocator(dev)
    eng = Engine(exp, fid_params(gold, ev_cap=REC_START_CAP,
                                 on_overflow="retry"), device=dev)
    guard = OverflowGuard(eng, make_engine=eng.at_caps, mode="retry")
    keep, shared, clone_s = guard.rollback_point, [], []

    def rollback_point(st):
        sync(dev)
        t = time.perf_counter()
        copy = keep(st)
        sync(dev)
        clone_s.append(time.perf_counter() - t)
        shared.append(len(set(mem.storage_ptrs(st))
                          & set(mem.storage_ptrs(copy))))
        return copy

    guard.rollback_point = rollback_point
    sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    st = run_chunked(eng, n_windows=gold["windows"], chunk=REC_CHUNK,
                     guard=guard)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = measured_peak(dev, base)
    missing = [k for k, n in launches.items() if n <= 0]
    require(not missing, f"retry run: kernels not launched: {missing}")
    require(guard.chunk_retries >= 1, "retry run: no chunk was retried")
    require(all(n == 0 for n in shared),
            f"retry run: a rollback copy shares storage with its state: "
            f"{shared}")
    check_net_golden("fidelity16k", gold, guard.engine, st,
                     drain_ring(st, eng.window))
    return dict(wall_s=wall, launches=launches, report=guard.report(),
                resizes=guard.resizes, clones=len(shared), clone_s=clone_s,
                peak=peak, rounds=int(st.metrics.rounds),
                final=guard.final_caps)


def recovery_halt(dev, gold, exp, tainted) -> dict:
    """Step 3: the same config under ``on_overflow=halt`` raises the
    structured error at the chunk the retry run replayed first."""
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.tune.ladder import cap_ladder
    from shadow1_tpu_torch.txn import CapacityExceededError, OverflowGuard

    eng = Engine(exp, fid_params(gold, ev_cap=REC_START_CAP,
                                 on_overflow="halt"), device=dev)
    t0 = time.perf_counter()
    try:
        run_chunked(eng, n_windows=gold["windows"], chunk=REC_CHUNK,
                    guard=OverflowGuard(eng, mode="halt"))
    except CapacityExceededError as e:
        err = e
    else:
        raise AssertionError("halt run: no CapacityExceededError")
    wall = time.perf_counter() - t0
    got = dict(knob=err.knob, counter=err.counter, cap=err.cap,
               windows=list(err.window_range), overflow=err.overflow,
               recommended=err.recommended)
    require(got["knob"] == "ev_cap" and got["counter"] == "ev_overflow"
            and got["cap"] == REC_START_CAP and got["overflow"] > 0
            and got["windows"] == list(tainted)
            and got["recommended"] in cap_ladder(1 << 20)
            and got["recommended"] > REC_START_CAP,
            f"halt run: {got} (the retry run replayed windows {tainted})")
    return dict(wall_s=wall, error=got)


def recovery_autocaps(dev, gold, exp) -> dict:
    """Step 4: fidelity16k from the golden's ev_cap under a CapController
    (a retry guard attached) with ``selfcheck``: it must shrink after its
    patience and equal the golden, every boundary identity holding."""
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry.ring import drain_ring
    from shadow1_tpu_torch.tune import CapController
    from shadow1_tpu_torch.txn import OverflowGuard

    base = clean_allocator(dev)
    eng = Engine(exp, fid_params(gold, on_overflow="retry"), device=dev)
    ctl = CapController(eng, eng.at_caps)
    guard = OverflowGuard(eng, mode="retry", controller=ctl)
    sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    st = run_chunked(eng, n_windows=gold["windows"], chunk=REC_CHUNK,
                     guard=guard, retune=ctl, selfcheck=True)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = measured_peak(dev, base)
    require(ctl.resizes and ctl.resizes[0]["ev_cap"][1] < gold["params"]
            ["ev_cap"], f"auto-caps run: no shrink: {ctl.resizes}")
    check_net_golden("fidelity16k", gold, guard.engine, st,
                     drain_ring(st, eng.window))
    return dict(wall_s=wall, launches=launches, resizes=ctl.resizes,
                report=guard.report(), peak=peak, final=guard.final_caps)


def resident_audit(dev, exp, params) -> dict:
    """Step 5: the estimate's resident bytes against what ``Engine`` and
    ``init_state`` allocate, measured from a clean allocator."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.core.engine import Engine

    est = mem.estimate(exp, params)
    base = clean_allocator(dev)
    eng = Engine(exp, params, device=dev)
    st = eng.init_state()
    sync(dev)
    import torch

    measured = torch.cuda.memory_allocated(dev) - base
    del st, eng
    clean_allocator(dev)
    ratio = est.resident_bytes / measured
    return dict(estimated=est.resident_bytes, measured=measured, ratio=ratio,
                peak=est.peak_bytes, planes=est.planes, peaks=est.peaks)


def recovery_drain(dev, gold, exp, cap: int) -> dict:
    """Steps 5 and 6: a pre-flight with SHADOW1_MEM_BYTES between the
    retry and the halt peaks at ``cap`` must downshift (drop the rollback
    copy, retry → halt). That run gets SIGTERM at the window-DRAIN_AT
    boundary under a DrainHandler: it must commit the in-flight chunk,
    write its snapshot and stop with PreemptedExit; a fresh Engine resumes
    from the snapshot and the whole must equal the golden."""
    from shadow1_tpu_torch import ckpt, mem
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.lineage import Lineage
    from shadow1_tpu_torch.obs import run_with_heartbeat
    from shadow1_tpu_torch.preempt import DrainHandler, PreemptedExit
    from shadow1_tpu_torch.telemetry.ring import drain_ring
    from shadow1_tpu_torch.txn import OverflowGuard

    import shutil

    retry = fid_params(gold, ev_cap=cap, on_overflow="retry")
    e_retry = mem.estimate(exp, retry)
    e_halt = mem.estimate(exp, fid_params(gold, ev_cap=cap,
                                          on_overflow="halt"))
    card_budget = mem.device_budget(dev)
    require(card_budget[1] == "backend" and card_budget[0] > e_retry.peak_bytes,
            f"the card's budget {card_budget}")
    budget_set = (e_retry.peak_bytes + e_halt.peak_bytes) // 2
    os.environ[mem.MEM_BYTES_ENV] = str(budget_set)
    try:
        budget, source = mem.device_budget(dev)
    finally:
        del os.environ[mem.MEM_BYTES_ENV]
    require((budget, source) == (budget_set, "env"), f"budget {budget}")
    params, actions = mem.downshift(exp, retry, budget)
    require([a["action"] for a in actions] == ["drop_rollback"]
            and params.on_overflow == "halt",
            f"downshift: {actions}, on_overflow {params.on_overflow}")
    windows = gold["windows"]
    shutil.rmtree(REC_DIR, ignore_errors=True)
    REC_DIR.mkdir(parents=True)
    path = str(REC_DIR / "fidelity16k.npz")
    eng = Engine(exp, params, device=dev)
    drain = DrainHandler().install()
    os.environ["SHADOW1_OBS_SIGTERM_SELF_AT_NS"] = str(DRAIN_AT * exp.window)
    t0 = time.perf_counter()
    try:
        run_with_heartbeat(eng, n_windows=windows, every_windows=REC_CHUNK,
                           stream=False, ckpt_path=path, ckpt_every_s=1e9,
                           guard=OverflowGuard(eng, mode="halt"), drain=drain)
    except PreemptedExit as e:
        pre = e
    else:
        raise AssertionError("drain run: no PreemptedExit")
    finally:
        del os.environ["SHADOW1_OBS_SIGTERM_SELF_AT_NS"]
        drain.uninstall()
    first_s = time.perf_counter() - t0
    done = DRAIN_AT + REC_CHUNK
    require(pre.signame == "SIGTERM" and pre.done_windows == done
            and pre.win_start == done * exp.window,
            f"drain: {pre.signame} after {pre.done_windows} windows")
    resolved = Lineage(path).resolve()
    require(resolved is not None and resolved.meta["done_windows"] == done,
            f"drain: snapshot {resolved}")
    del pre, eng
    eng = Engine(exp, params, device=dev)
    t1 = time.perf_counter()
    st = ckpt.load_state(eng.init_state(), resolved.path)
    st = eng.run(st, n_windows=windows - done)
    sync(dev)
    second_s = time.perf_counter() - t1
    check_net_golden("fidelity16k", gold, eng, st, drain_ring(st, eng.window))
    snap_bytes = os.path.getsize(resolved.path)
    shutil.rmtree(REC_DIR, ignore_errors=True)
    return dict(budget=budget, card_budget=card_budget[0],
                retry_peak=e_retry.peak_bytes,
                halt_peak=e_halt.peak_bytes, actions=actions, done=done,
                first_s=first_s, second_s=second_s, snap_bytes=snap_bytes)


def recovery_oom(dev, gold, exp) -> dict:
    """Step 5: the card's own allocator OOM. The per-process memory
    fraction is lowered to what is reserved now plus 64 MiB, so
    ``init_state`` of fidelity16k fails; ``mem.is_oom`` must classify the
    failure. The fraction is restored and the cache emptied after."""
    import torch

    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.core.engine import Engine

    eng = Engine(exp, fid_params(gold), device=dev)
    clean_allocator(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    frac = (torch.cuda.memory_reserved(dev) + (64 << 20)) / total
    torch.cuda.set_per_process_memory_fraction(frac)
    try:
        eng.init_state()
        sync(dev)
    except Exception as e:  # noqa: BLE001 — classified below
        err = e
    else:
        raise AssertionError("oom probe: init_state did not fail")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    require(mem.is_oom(err), f"mem.is_oom missed: {type(err).__name__}: "
            f"{str(err)[:300]}")
    out = dict(fraction=frac, type=type(err).__name__,
               message=str(err).splitlines()[0][:160])
    del err, eng
    clean_allocator(dev)
    return out


def phase_recovery(dev, card: str) -> dict:
    """Phase 14: the recovery planes on fidelity16k at full width (its
    step 1, the kernels at the ladder caps, runs among the kernel phases:
    ``recovery_kernels``)."""
    step_s = {}

    def step(name, t0):
        step_s[name] = time.perf_counter() - t0
        log(f"  recovery step {name}: {step_s[name]:.1f} s wall")

    gold = net_golden("fidelity16k")
    exp = net_experiment("fidelity16k", gold)
    t0 = time.perf_counter()
    retry = recovery_retry(dev, gold, exp)
    caps = [REC_START_CAP] + [r["ev_cap"][1] for r in retry["resizes"]]
    log(f"recovery retry: fidelity16k from ev_cap {REC_START_CAP}, chunks "
        f"of {REC_CHUNK} windows, in {retry['wall_s']:.3f} s "
        f"({retry['rounds']} committed rounds); equal to the JAX golden; "
        f"{json.dumps(retry['report'])}; ev_cap sequence {caps}; resizes "
        f"{json.dumps(retry['resizes'])}; {retry['clones']} rollback "
        f"clones, none sharing storage, {sum(retry['clone_s']):.4f} s in "
        f"all (max {max(retry['clone_s']):.4f} s); launches "
        f"{retry['launches']} on {card}")
    step("retry", t0)

    t0 = time.perf_counter()
    tainted = retry["resizes"][0]["windows"]
    halt = recovery_halt(dev, gold, exp, tainted)
    log(f"recovery halt: CapacityExceededError {json.dumps(halt['error'])} "
        f"after {halt['wall_s']:.3f} s")
    step("halt", t0)

    t0 = time.perf_counter()
    auto = recovery_autocaps(dev, gold, exp)
    log(f"recovery auto-caps: fidelity16k from ev_cap "
        f"{gold['params']['ev_cap']} under CapController with selfcheck and "
        f"a retry guard in {auto['wall_s']:.3f} s; equal to the JAX golden, "
        f"every boundary identity held; resizes "
        f"{json.dumps(auto['resizes'])}; guard {json.dumps(auto['report'])}")
    step("auto-caps", t0)

    t0 = time.perf_counter()
    final = retry["final"]["ev_cap"]
    audits = {
        "fidelity16k@512": resident_audit(dev, exp, fid_params(
            gold, on_overflow="retry")),
        f"fidelity16k@{REC_START_CAP}": resident_audit(dev, exp, fid_params(
            gold, ev_cap=REC_START_CAP, on_overflow="retry")),
    }
    tg = net_golden("tgen50k")
    from shadow1_tpu_torch.consts import EngineParams

    audits["tgen50k"] = resident_audit(dev, net_experiment("tgen50k", tg),
                                       EngineParams(**tg["params"]))
    for name, a in audits.items():
        log(f"recovery memory {name}: resident estimate {a['estimated']} B "
            f"vs memory_allocated after init_state {a['measured']} B "
            f"(ratio {a['ratio']:.4f}); peak estimate {a['peak']} B; planes "
            f"{json.dumps(a['planes'])}; peaks {json.dumps(a['peaks'])}")
        require(abs(a["ratio"] - 1) <= 0.10,
                f"{name}: resident estimate off by more than 10 %")
    from shadow1_tpu_torch import mem

    peaks = {
        f"retry (final ev_cap {final})": (
            mem.estimate(exp, fid_params(gold, ev_cap=final,
                                         on_overflow="retry")).peak_bytes,
            retry["peak"]),
        "auto-caps (from ev_cap 512)": (
            audits["fidelity16k@512"]["peak"], auto["peak"]),
    }
    for name, (est, got) in peaks.items():
        log(f"recovery memory peak, {name}: estimate {est} B vs "
            f"max_memory_allocated {got['allocated']} B (ratio "
            f"{est / got['allocated']:.4f}); max_memory_reserved "
            f"{got['reserved']} B")
        require(est >= got["allocated"],
                f"{name}: the peak estimate is below the measured peak")
    step("memory audit", t0)

    t0 = time.perf_counter()
    dr = recovery_drain(dev, gold, exp, final)
    log(f"recovery budget of the card (mem_get_info free + reserved): "
        f"{dr['card_budget']} B")
    log(f"recovery downshift and drain at ev_cap {final}: budget "
        f"{dr['budget']} B between the retry peak {dr['retry_peak']} B and "
        f"the halt peak {dr['halt_peak']} B, downshift "
        f"{json.dumps(dr['actions'])}; SIGTERM at the window-{DRAIN_AT} "
        f"boundary, PreemptedExit after {dr['done']} committed windows with "
        f"the snapshot written ({dr['snap_bytes']} B; {dr['first_s']:.3f} "
        f"s); a fresh Engine "
        f"resumed it to the end in {dr['second_s']:.3f} s; equal to the JAX "
        f"golden")
    step("downshift and drain", t0)

    t0 = time.perf_counter()
    oom = recovery_oom(dev, gold, exp)
    log(f"recovery OOM: memory fraction {oom['fraction']:.5f} made "
        f"init_state fail with {oom['type']}: {oom['message']}; "
        f"mem.is_oom classified it")
    step("allocator OOM", t0)
    return dict(retry=retry, halt=halt, auto=auto, audits=audits, drain=dr,
                oom=oom, step_s=step_s)


# -- phase 15: the fleet ---------------------------------------------------

FLEET_DIR = ROOT / "build" / "chip_smoke_fleet"
# fleet_filexfer16k: lane 0 is filexfer16k's golden experiment, lanes 1-3
# its seed and loss variants (seed, edge loss); FLEET_WINDOWS windows.
FLEET_LANES = ((2, 0.001), (3, 0.01), (4, 0.02))
FLEET_WINDOWS = 10
# Step 3 keeps three rounds of this window of fleet_filexfer16k.
FLEET_PATH_WINDOW = 8
# Step 4: the under-sized ev_cap of the retry and halt runs, the chunk,
# the window of the snapshot and the slice, and the lane forced to fail.
FLEET_SMALL_CAP, FLEET_CHUNK, FLEET_SPLIT, FLEET_FAIL = 4, 5, 10, 5


def fleet_golden() -> dict:
    return json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / "fleet_sweep_phold.json").read_text())


def fleet_sweep_engine(dev, **repl):
    """The golden's 17-lane sweep (``sweep_phold_experiments``) as a
    FleetEngine on ``dev``, the ring and digest words on; ``repl``
    overrides engine params."""
    import dataclasses

    from shadow1_tpu_torch.config.compiled import sweep_phold_experiments
    from shadow1_tpu_torch.fleet.engine import FleetEngine

    gold = fleet_golden()
    exps, params, max_rounds, labels = sweep_phold_experiments()
    require(labels == [l["label"] for l in gold["lanes"]]
            and max_rounds == gold["max_rounds"],
            "fleet_sweep_phold: the sweep built here is not the golden's")
    params = dataclasses.replace(params, metrics_ring=gold["windows"],
                                 state_digest=1, **repl)
    return FleetEngine(exps, params, max_rounds, device=dev), labels


def check_fleet_lanes(eng, st, *, what: str, first: int = 0) -> None:
    """Every lane still in ``eng`` (by its sweep-global id) against the
    golden: every Metrics field, the digest words of windows ``first`` on
    and the SHA-256 of the per-host hop counts."""
    import numpy as np

    gold = fleet_golden()
    fields = gold["digest_fields"]
    per = eng.metrics_per_exp(st)
    rings = eng.drain_rings(st, start=first)
    ids = eng.exp_ids or list(range(eng.n_exp))
    for e, gid in enumerate(ids):
        lane = gold["lanes"][gid]
        diff = {k: (lane["metrics"][k], v) for k, v in per[e].items()
                if lane["metrics"][k] != v}
        require(not diff, f"{what}: lane {gid} metrics differ from the "
                f"golden (golden, port): {diff}")
        rows = [[r[f] for f in fields] for r in rings
                if r["exp"] == gid and r["type"] == "ring"]
        want = lane["digests"][first:]
        for w, (a, b) in enumerate(zip(want, rows), start=first):
            require(a == b, f"{what}: lane {gid} window {w}: digest words "
                    f"{b} differ from the golden's {a}")
        require(len(rows) == len(want), f"{what}: lane {gid}: {len(rows)} "
                f"ring rows, {len(want)} due")
        hops = eng.model_summary(st, e)["hops"]
        h = hashlib.sha256(np.asarray(hops, "<i8").tobytes()).hexdigest()
        require(h == lane["sha256"]["hops"],
                f"{what}: lane {gid} per-host hops differ from the golden")


class UntilCapture:
    """A hook around ``engine.pop_until`` that keeps a clone of the first
    call whose bound is one per host (a lane at its ``max_rounds`` cap
    while others run on)."""

    def __init__(self):
        self.args = None

    def __enter__(self):
        from shadow1_tpu_torch.core import engine

        pop = self._pop = engine.pop_until

        def hook(buf, until, extract="sum"):
            if self.args is None and getattr(until, "dim", lambda: 0)() == 1:
                self.args = (clone(buf), until.clone())
            return pop(buf, until, extract)

        engine.pop_until = hook
        return self

    def __exit__(self, *exc):
        from shadow1_tpu_torch.core import engine

        engine.pop_until = self._pop


def fleet_sweep(dev) -> dict:
    """Step 1: the 17-lane sweep against the golden, its launches counted
    from 0; pop's per-host bound (the capped lane) against its plain
    version."""
    from shadow1_tpu_torch.core import popk

    eng, labels = fleet_sweep_engine(dev)
    sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    with UntilCapture() as cap:
        st = eng.run(n_windows=fleet_golden()["windows"])
        sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES)
    require(all(n > 0 for n in launches.values()),
            f"fleet_sweep_phold: kernels not launched: {launches}")
    check_fleet_lanes(eng, st, what="fleet_sweep_phold")
    per = eng.metrics_per_exp(st)
    require(per[-1]["round_cap_hits"] > 0 and cap.args is not None,
            "fleet_sweep_phold: the capped lane never held at its cap")
    buf, until = cap.args
    err = bit_equal("pop[per-host bound]", popk.pop_until_plain(buf, until),
                    popk.pop_until(clone(buf), until))
    return dict(wall_s=wall, launches=launches, lanes=len(per),
                rounds=max(m["rounds"] for m in per),
                events=sum(m["events"] for m in per),
                cap_hits=per[-1]["round_cap_hits"], until_err=err,
                held=int((until < until.max()).sum()))


def fleet_filexfer_experiments():
    import dataclasses

    from shadow1_tpu_torch.config import compiled as ct

    gold = net_golden("filexfer16k")
    exp0 = net_experiment("filexfer16k", gold)
    (builder, kwargs), = gold["build"].items()
    exps = [exp0] + [getattr(ct, builder)(**dict(kwargs, seed=s), loss=lo)
                     for s, lo in FLEET_LANES]
    for e in exps[1:]:
        require(dataclasses.replace(e, seed=exp0.seed).n_hosts
                == exp0.n_hosts, "fleet lane shape")
    return gold, exps


def fleet_filexfer(dev) -> dict:
    """Step 2: fleet_filexfer16k (4 lanes, 65,536 columns) — the main
    path's launches counted from 0; lane 0's ring rows against
    net_filexfer16k.json; every lane against the port's solo Engine on the
    card; mem.estimate against the allocator; device ops and reads per
    round counted on the windows that follow (``CountedWindows``), lane 0
    solo's ops on its own window FLEET_WINDOWS."""
    import numpy as np
    import torch

    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.fleet.engine import FleetEngine
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    gold, exps = fleet_filexfer_experiments()
    params = EngineParams(**gold["params"], metrics_ring=FLEET_WINDOWS + 1,
                          state_digest=1)
    est = mem.estimate(exps[0], params, fleet=(exps, None))
    base = clean_allocator(dev)
    eng = FleetEngine(exps, params, device=dev)
    st = eng.init_state()
    sync(dev)
    resident = torch.cuda.memory_allocated(dev) - base
    ratio = est.resident_bytes / resident
    require(abs(ratio - 1) <= mem.AUDIT_TOLERANCE,
            f"fleet_filexfer16k: mem.estimate {est.resident_bytes} B vs "
            f"{resident} B allocated after init_state (ratio {ratio:.3f})")
    zero_counts()
    t0 = time.perf_counter()
    held = [st]  # handed over: no frame keeps the initial state
    st = None
    st = eng.run(held.pop(), n_windows=FLEET_WINDOWS)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES)
    entries = dict(popk.PUSH_ENTRIES)
    peak = measured_peak(dev, base)
    require(est.peak_bytes >= peak["allocated"],
            f"fleet_filexfer16k: mem.estimate's peak {est.peak_bytes} B is "
            f"below the measured {peak['allocated']} B")
    require(all(n > 0 for n in launches.values()),
            f"fleet_filexfer16k: kernels not launched: {launches}")
    per = eng.metrics_per_exp(st)
    rings = eng.drain_rings(st)
    rounds = max(m["rounds"] for m in per)
    lane0 = [r for r in rings if r["exp"] == 0]
    check_digests("fleet_filexfer16k lane 0", gold, lane0, 0, FLEET_WINDOWS)
    solo_wall = 0.0
    for e, exp in enumerate(exps):
        solo = Engine(exp, params, device=dev)
        sync(dev)
        t1 = time.perf_counter()
        ss = solo.run(n_windows=FLEET_WINDOWS)
        sync(dev)
        solo_wall += time.perf_counter() - t1
        require(Engine.metrics_dict(ss) == per[e],
                f"fleet_filexfer16k lane {e}: metrics differ from the solo "
                f"run's")
        require(drain_ring(ss, solo.window) == [
            {k: v for k, v in r.items() if k != "exp"} for r in rings
            if r["exp"] == e], f"fleet_filexfer16k lane {e}: ring rows "
            f"differ from the solo run's")
        a, b = solo.model_summary(ss), eng.model_summary(st, e)
        require(all(np.array_equal(a[k], b[k]) for k in a),
                f"fleet_filexfer16k lane {e}: summaries differ from the "
                f"solo run's")
        if e == 0:
            # Lane 0's solo run goes on: its window FLEET_WINDOWS counted,
            # the fleet's first counted window below.
            with CountedWindows(solo, FLEET_WINDOWS,
                                lambda s: int(s.metrics.rounds),
                                stages=("ops",)) as cw:
                while cw.todo:
                    ss = solo.run(ss, n_windows=1)
            solo_ops = cw.costs["ops_per_round"]
            count_s = cw.wall_s
        del ss, solo
    # The fleet's run goes on: device operations and host reads per round
    # of its windows from FLEET_WINDOWS on.
    with CountedWindows(eng, FLEET_WINDOWS, lambda s: int(
            s.metrics.rounds.max())) as cw:
        while cw.todo:
            st = eng.run(st, n_windows=1)
    del st
    return dict(wall_s=wall, launches=launches, push_entries=entries,
                solo_ops_per_round=solo_ops,
                rounds=rounds, windows=FLEET_WINDOWS, hosts=eng.ctx.n_hosts,
                events=sum(m["events"] for m in per), solo_wall_s=solo_wall,
                resident=resident, estimated=est.resident_bytes,
                ratio=ratio, peak=peak, est_peak=est.peak_bytes,
                count_s=count_s + cw.wall_s, **cw.costs)


def fleet_path(dev, flush) -> dict:
    """Step 3: three rounds of window FLEET_PATH_WINDOW of step 2's fleet,
    each kernel against its plain version and timed (check_path)."""
    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.fleet.engine import FleetEngine

    gold, exps = fleet_filexfer_experiments()
    eng = FleetEngine(exps, EngineParams(**gold["params"]), device=dev)
    with NetPathCapture(FLEET_PATH_WINDOW) as cap:
        eng.run(n_windows=FLEET_PATH_WINDOW + 1)
        sync(dev)
    out = {name: check_path(name, cap.cases(name), dev, flush, expect=(1, 3))
           for name in ("pop", "push", "obox")}
    return dict(kernels=out, actives=cap.actives())


def fleet_recovery(dev) -> dict:
    """Step 4 on the sweep, each held to the golden: retry from a small
    ev_cap; halt naming the lane and its seed; quarantine of a lane forced
    to fail (a self-check violation), survivors equal; a snapshot at
    window FLEET_SPLIT resumed in a fresh FleetEngine; the capped lane
    sliced there and resumed in a solo Engine."""
    import dataclasses

    from shadow1_tpu_torch import ckpt, txn
    from shadow1_tpu_torch.convert import fleet_to_saved
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.fleet.run import run_fleet
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    out, step_s = {}, {}
    w = fleet_golden()["windows"]
    FLEET_DIR.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    eng, _ = fleet_sweep_engine(dev, ev_cap=FLEET_SMALL_CAP,
                                on_overflow="retry")
    st, hb = run_fleet(eng, n_windows=w, every_windows=FLEET_CHUNK,
                       stream=False)
    check_fleet_lanes(hb.engine, st, what="fleet retry")
    require(hb.guard.chunk_retries > 0, "fleet retry: no chunk replayed")
    out["retry"] = dict(retries=hb.guard.chunk_retries,
                        ev_cap=hb.engine.params.ev_cap)
    step_s["retry"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    eng, labels = fleet_sweep_engine(dev, ev_cap=FLEET_SMALL_CAP,
                                     on_overflow="halt")
    try:
        run_fleet(eng, n_windows=w, every_windows=FLEET_CHUNK, stream=False)
    except txn.CapacityExceededError as e:
        lane = labels[e.lanes[0]]
        named = f"fleet experiment {lane['exp']}, seed {lane['seed']}"
        require(named in str(e), f"fleet halt: {e} does not name {named}")
        out["halt"] = dict(lane=lane["exp"], seed=lane["seed"],
                           window_range=e.window_range)
    else:
        raise AssertionError("fleet halt: no CapacityExceededError")
    step_s["halt"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    check = txn.check_boundary_identity

    def failing(metrics, where=""):
        if where.startswith(f"fleet experiment {FLEET_FAIL},") and \
                metrics.get("windows", 0) >= FLEET_SPLIT:
            raise txn.SelfCheckError({"pkts_sent": 1}, 1, where=where)
        return check(metrics, where=where)

    txn.check_boundary_identity = failing
    try:
        eng, _ = fleet_sweep_engine(dev, on_lane_fail="quarantine")
        st, hb = run_fleet(eng, n_windows=w, every_windows=FLEET_CHUNK,
                           stream=False, selfcheck=True,
                           quarantine_base=str(FLEET_DIR / "lane"))
    finally:
        txn.check_boundary_identity = check
    (q,) = hb.recovery["quarantined"]
    require(q["exp"] == FLEET_FAIL and q["reason"] == "selfcheck",
            f"fleet quarantine: {q}")
    require(hb.engine.n_exp == 16, "fleet quarantine: survivors")
    check_fleet_lanes(hb.engine, st, what="fleet quarantine survivors")
    out["quarantine"] = dict(exp=q["exp"], window=q["window"],
                             survivors=q["survivors"])
    step_s["quarantine"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    eng, _ = fleet_sweep_engine(dev)
    half = eng.run(n_windows=FLEET_SPLIT)
    path = str(FLEET_DIR / "fleet.npz")
    ckpt.save_state(fleet_to_saved(half, eng.n_exp), path)
    lane_path = str(FLEET_DIR / "lane16.npz")
    capped = eng.n_exp - 1
    ckpt.save_state(eng.slice_experiment(half, capped), lane_path)
    fresh, _ = fleet_sweep_engine(dev)
    st = ckpt.load_fleet_state(fresh.init_state(), path, fresh.n_exp)
    st = fresh.run(st, n_windows=w - FLEET_SPLIT)
    check_fleet_lanes(fresh, st, what="fleet resume")
    solo = Engine(fresh.exps[capped], dataclasses.replace(
        fresh.params, max_rounds=fresh.max_rounds[capped]), device=dev)
    ss = solo.run(ckpt.load_state(solo.init_state(), lane_path),
                  n_windows=w - FLEET_SPLIT)
    gold = fleet_golden()["lanes"][capped]
    require(Engine.metrics_dict(ss) == gold["metrics"],
            "fleet slice: the solo resume differs from the golden lane")
    rows = [[r[f] for f in fleet_golden()["digest_fields"]]
            for r in drain_ring(ss, solo.window)]
    require(rows == gold["digests"], "fleet slice: digest words differ")
    out["resume"] = dict(snap_bytes=os.path.getsize(path))
    step_s["resume and slice"] = time.perf_counter() - t0
    import shutil

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    out["step_s"] = step_s
    return out


# -- phase 16: the serve plane ----------------------------------------------

SERVE_DIR = ROOT / "build" / "s16"
# configs/dense_tgen50k.yaml as the JSON a tenant submits (the card has no
# YAML parser), cut to SERVE_WINDOWS windows of 10 ms, the digest words on:
# the experiment of golden/net_tgen50k.json for seed 71.
SERVE_WINDOWS = 20
TGEN50K_DOC = {
    "general": {"seed": 71, "stop_time": "200 ms"},
    "engine": {"scheduler": "tpu", "ev_cap": 96, "outbox_cap": 32,
               "sockets_per_host": 8, "msgq_cap": 4, "max_rounds": 512,
               "rcvbuf": 16384, "state_digest": 1},
    "network": {"single_vertex": {"latency": "10 ms"}},
    "hosts": [{"name": "node", "count": 50000, "bandwidth_up": "20 Mbit",
               "bandwidth_down": "20 Mbit"}],
    "app": {"model": "tgen", "params": {"fixed_size": True},
            "defaults": {"start_time": "10 ms"},
            "groups": {"node": {"active": 1, "streams": 1000000,
                                "mean_bytes": 30000000,
                                "mean_think_ns": "50 ms"}}},
}
SERVE_SEEDS = (71, 72)
# Step (a) keeps three rounds of this window of the served batch.
SERVE_PATH_WINDOW = 8
# What may stay allocated between two served batches beyond the cached
# engine's ctx tables (the allocator rounds each block up to 512 B).
LEFTOVER_SLACK = 1 << 20
# Step (b), for tools/serveprobe.py: configs/serve_phold.yaml as JSON, and
# configs/mem_overbudget.yaml's PHOLD at 65,536 hosts and ev_cap 16,384
# (its event buffer alone ~69 GB, so it never fits the card; fewer hosts
# make its pricing on the meta device quicker).
SERVE_PHOLD_DOC = {
    "general": {"seed": 5, "stop_time": "40 ms"},
    "engine": {"scheduler": "tpu", "ev_cap": 32, "metrics_ring": 10,
               "state_digest": 1},
    "network": {"single_vertex": {"latency": "1 ms"}},
    "hosts": [{"name": "h", "count": 8}],
    "app": {"model": "phold",
            "params": {"mean_delay_ns": 2000000.0, "init_events": 3}},
}
OVERBUDGET_DOC = {
    "general": {"seed": 1, "stop_time": "1 s"},
    "engine": {"scheduler": "tpu", "ev_cap": 16384, "outbox_cap": 64,
               "metrics_ring": 256},
    "network": {"single_vertex": {"latency": "10 ms"}},
    "hosts": [{"name": "h", "count": 65536}],
    "app": {"model": "phold",
            "params": {"mean_delay_ns": 2.0e7, "init_events": 8}},
}


def tgen_job(seed: int) -> str:
    """The tenant's config file for ``seed`` (JSON text)."""
    doc = json.loads(json.dumps(TGEN50K_DOC))
    doc["general"]["seed"] = seed
    path = SERVE_DIR / f"tgen50k_{seed}.json"
    path.write_text(json.dumps(doc))
    return str(path)


class ServeProbe:
    """Instruments one in-process ``ServeDaemon``: times its cache lookups
    (an engine build on a miss, a rebind on a hit) and its lineage saves,
    records the engines it serves and the FleetEngines built on the card
    (meta-device builds of the memory estimate excluded), and samples the
    idle budget at each chunk boundary of a batch (the eviction latch's
    TTL sweep)."""

    def __init__(self, daemon, dev):
        self.d, self.dev = daemon, dev
        self.gets, self.saves, self.budgets, self.built = [], [], [], 0

    def __enter__(self):
        from shadow1_tpu_torch.fleet.engine import FleetEngine
        from shadow1_tpu_torch.lineage import Lineage

        d, probe = self.d, self
        get, expire = d.cache.get, d._expire_ttl
        init, save = FleetEngine.__init__, Lineage.save

        def timed_get(*a, **kw):
            t0 = time.perf_counter()
            eng, out = get(*a, **kw)
            sync(probe.dev)
            probe.gets.append((out, time.perf_counter() - t0, eng))
            return eng, out

        def sampled_expire():
            probe.budgets.append(d._budget()[0])
            return expire()

        def counted_init(eng, *a, **kw):
            init(eng, *a, **kw)
            probe.built += eng.device.type != "meta"

        def timed_save(lin, st, meta=None):
            t0 = time.perf_counter()
            seq = save(lin, st, meta)
            probe.saves.append(time.perf_counter() - t0)
            return seq

        d.cache.get, d._expire_ttl = timed_get, sampled_expire
        FleetEngine.__init__, Lineage.save = counted_init, timed_save
        self._saved = (FleetEngine, init, Lineage, save)
        return self

    def __exit__(self, *exc):
        fe, init, lin, save = self._saved
        fe.__init__, lin.save = init, save
        del self.d.cache.get, self.d._expire_ttl


def served_rows(spool, job: str) -> list:
    return [r for r in spool.read_results(job) if r["type"] == "ring"]


def served_final(spool, job: str) -> dict:
    final, = [r for r in spool.read_results(job) if r["type"] == "fleet_exp"]
    return final


def serve_batch(d, jobs, probe) -> dict:
    """Submit ``jobs`` ((job id, seed) pairs) through the client, take
    them in and run them as one batch; every one must be done in one batch
    of len(jobs) lanes."""
    from shadow1_tpu_torch.serve import client

    for jid, seed in jobs:
        client.submit(d.spool.root, tgen_job(seed), job_id=jid)
    t0 = time.perf_counter()
    d._safe_intake()
    intake = time.perf_counter() - t0
    require(all(jid in d.jobs for jid, _ in jobs),
            f"serve: jobs not admitted: {[d.spool.read_status(j) for j, _ in jobs]}")
    exps = {jid: d.jobs[jid].exp for jid, _ in jobs}
    params = d.jobs[jobs[0][0]].params
    sync(d.device)
    t0 = time.perf_counter()
    require(d.step(), "serve: the daemon ran no batch")
    step_s = time.perf_counter() - t0
    done = [e for e in _serve_log(d) if e.get("event") == "batch_done"][-1]
    for jid, _ in jobs:
        st = d.spool.read_status(jid)
        require(st["state"] == "done" and st["lanes"] == len(jobs),
                f"serve: job {jid} is {st}")
    finals = {jid: served_final(d.spool, jid) for jid, _ in jobs}
    return dict(exps=exps, params=params, intake_s=intake, step_s=step_s,
                wall_s=done["wall_s"], finals=finals,
                rounds=max(f["metrics"]["rounds"] for f in finals.values()),
                events=sum(f["metrics"]["events"] for f in finals.values()),
                cache=[e for e in _serve_log(d)
                       if e.get("event") == "batch_start"][-1]["cache"])


def _serve_log(d) -> list:
    with open(d.spool.log_path) as f:
        return [json.loads(line) for line in f if line.strip()]


def serve_solo(dev, exp, params) -> dict:
    """The solo Engine on the card over SERVE_WINDOWS windows, the device
    ops and reads counted on windows SERVE_WINDOWS / 2 on of the run
    (``CountedWindows``), whose wall and rounds are left out of the
    timing."""
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    eng = Engine(exp, params, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    with CountedWindows(eng, SERVE_WINDOWS // 2,
                        lambda s: int(s.metrics.rounds)) as cw:
        st = eng.run(n_windows=SERVE_WINDOWS)
        sync(dev)
    wall = time.perf_counter() - t0 - cw.wall_s
    m = Engine.metrics_dict(st)
    return dict(wall_s=wall, rows=drain_ring(st, eng.window), metrics=m,
                rounds=m["rounds"] - cw.rounds, events=m["events"],
                **cw.costs)


def windows_of(st) -> int:
    return int(st.metrics.windows.max())


class CountedWindows:
    """Device operations and device→host reads per round, counted on
    windows of a run that is there anyway: a hook on ``eng.run`` that,
    from window ``at`` on, runs one window under ``torch.profiler``
    (counted; when CUPTI hands back no record, again on the next window,
    up to ``attempts`` times), then one under ``sync_reads`` (a warm-up:
    some sync warnings are issued once a process) and one under
    ``sync_reads`` (counted). Every other window runs as it would, in the
    calls the caller made. ``wall_s`` and ``rounds`` are those of the
    counted windows, for callers that time the run around them; ``costs``
    the counts per round (``ops_per_round``, ``reads_per_round``, and
    ``extra_rounds``, the counted ops window's rounds)."""

    def __init__(self, eng, at: int, rounds_of, attempts: int = 3,
                 stages=("ops", "warm-up", "reads")):
        self.eng, self.at, self.rounds_of = eng, at, rounds_of
        self.attempts = attempts
        self.todo = list(stages)
        self.wall_s, self.rounds = 0.0, 0
        self.costs = {}

    def __enter__(self):
        self._own = self.eng.__dict__.get("run")
        self._run = self.eng.run
        self.eng.run = self.run
        return self

    def __exit__(self, *exc):
        if self._own is None:
            del self.eng.run
        else:
            self.eng.run = self._own

    def run(self, st=None, n_windows=None):
        # The state is handed over call to call (``held``), as
        # ``ckpt.run_chunked`` does: no frame here keeps a window's input
        # alive past the window, or the peak would hold a third state.
        held = [self.eng.init_state() if st is None else st]
        del st
        n = self.eng.n_windows if n_windows is None else int(n_windows)
        while n > 0:
            k = n
            if self.todo:
                w = windows_of(held[0])
                if w >= self.at:
                    held.append(self._counted(held.pop()))
                    n -= 1
                    continue
                k = min(n, self.at - w)
            held.append(self._run(held.pop(), n_windows=k))
            n -= k
        return held.pop()

    def _counted(self, st):
        from torch.autograd.profiler import _filter_name
        from torch.profiler import ProfilerActivity, profile

        stage, box = self.todo[0], {"in": [st]}
        r0 = self.rounds_of(st)
        del st

        def step():
            box["st"] = self._run(box["in"].pop(), n_windows=1)
            sync(self.eng.device)

        t0 = time.perf_counter()
        if stage == "ops":
            # Device records only, counted from the profiler's raw events:
            # the host ops' records and ``key_averages``' event objects
            # would cost more than the window they count (~1,000 a round).
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.02)
                step()
                time.sleep(0.02)
            ops = sum(1 for e in prof.profiler.kineto_results.events()
                      if str(e.device_type()).endswith("CUDA")
                      and not _filter_name(e.name()))
            self.attempts -= 1
            require(ops or self.attempts > 0, "torch.profiler recorded no "
                    "device operation in the counted windows")
        else:
            ops = sync_reads(step)
        self.wall_s += time.perf_counter() - t0
        rounds = self.rounds_of(box["st"]) - r0
        self.rounds += rounds
        if stage == "ops" and ops:
            self.costs.update(ops_per_round=ops / max(rounds, 1),
                              extra_rounds=rounds)
        elif stage == "reads":
            self.costs["reads_per_round"] = ops / max(rounds, 1)
        if stage != "ops" or ops:
            self.todo.pop(0)
        return box["st"]


def serve_tgen(dev, flush) -> dict:
    """Step (a): the in-process daemon on the card, full width."""
    import shutil

    import torch

    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.config import compiled as ct
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.serve.daemon import ServeDaemon

    # A module that binds a kernel's wrapper when it is imported (``from
    # ...popk import push_local``) must be imported before the path hooks
    # go in, or it keeps the hook, and the hook's clones, for good.
    import importlib

    for name in ("core.phold", "net", "tcp.tcp", "apps.bitcoin",
                 "apps.dgram", "apps.filexfer", "apps.tgen", "apps.tor"):
        importlib.import_module(f"shadow1_tpu_torch.{name}")

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    gold = net_golden("tgen50k")
    d = ServeDaemon(str(SERVE_DIR / "spool"), ckpt_every_s=1e9,
                    device=dev).start()
    try:
        with ServeProbe(d, dev) as probe:
            # (1)-(2): seeds 71 and 72 as one 2-lane batch, launches counted
            # from 0 over it, three rounds' kernel arguments kept.
            budget0 = d._budget()[0]
            base = clean_allocator(dev)
            zero_counts()
            with NetPathCapture(SERVE_PATH_WINDOW) as cap:
                b1 = serve_batch(d, (("a71", 71), ("a72", 72)), probe)
            launches = dict(popk.LAUNCHES)
            entries = dict(popk.PUSH_ENTRIES)
            require(all(n > 0 for n in launches.values()),
                    f"serve: kernels not launched on the batch: {launches}")
            budget_in = list(probe.budgets)
            budget1 = d._budget()[0]
            # Two-tier admission needs the IDLE budget: the daemon's own
            # resident batch must not shrink it.
            require(min(budget_in + [budget1]) >= 0.99 * budget0,
                    f"serve: the budget shrank while the batch was resident: "
                    f"{budget0} B idle, {budget_in} B at its boundaries, "
                    f"{budget1} B after")
            sha = hashlib.sha256(json.dumps(
                ct.experiment_arrays(b1["exps"]["a71"]),
                sort_keys=True).encode()).hexdigest()
            require(sha == gold["experiment_sha256"],
                    "serve: the daemon's seed-71 experiment is not the "
                    "golden's")
            rows71 = served_rows(d.spool, "a71")
            check_digests("served tgen50k seed 71", gold, rows71, 0,
                          SERVE_WINDOWS)
            require(b1["finals"]["a71"]["metrics"] == gold["metrics"],
                    "serve: seed 71's metrics differ from the golden's")
            kernels = {name: check_path(name, cap.cases(name), dev, flush,
                                        expect=(1, 3))
                       for name in ("pop", "push", "obox")}
            actives = cap.actives()
            del cap
            params = b1["params"]
            solo = serve_solo(dev, b1["exps"]["a72"], params)
            rows72 = served_rows(d.spool, "a72")
            require(_bare(rows72) == solo["rows"],
                    "serve: seed 72's ring rows differ from its solo run's")
            require(b1["finals"]["a72"]["metrics"] == solo["metrics"],
                    "serve: seed 72's metrics differ from its solo run's")
            build_s = [s for out, s, _ in probe.gets if out == "miss"]
            require(len(build_s) == 1 and probe.built == 1,
                    f"serve: batch 1 built {probe.built} engines")
            engine1 = probe.gets[-1][2]
            # (3): the lanes swapped — a cache hit, the same engine, no
            # FleetEngine built; each stream equal to batch 1's.
            built0, n_saves = probe.built, len(probe.saves)
            # The swapped batch's peak, over what is allocated before it:
            # the cached engine's ctx tables (the estimate's ``const``)
            # among it.
            before = clean_allocator(dev)
            # Its device ops and reads per round, counted on its own
            # windows from SERVE_WINDOWS / 2 on (CountedWindows).
            with CountedWindows(
                    engine1, SERVE_WINDOWS // 2,
                    lambda s: int(s.metrics.rounds.max())) as cw:
                b2 = serve_batch(d, (("b72", 72), ("b71", 71)), probe)
            peak = measured_peak(dev, before)
            require(not cw.todo, f"serve: the counted windows did not all "
                    f"run: {cw.todo} left")
            out, rebind_s, engine2 = probe.gets[-1]
            require(out == "hit" and b2["cache"] == "hit",
                    f"serve: the swapped batch was a {out}")
            require(engine2 is engine1 and probe.built == built0,
                    "serve: the hit built an engine")
            for new, old in (("b71", "a71"), ("b72", "a72")):
                require(_bare(served_rows(d.spool, new))
                        == _bare(served_rows(d.spool, old)),
                        f"serve: {new}'s stream differs from {old}'s")
        exps = [b2["exps"]["b72"], b2["exps"]["b71"]]
    finally:
        d.close()
    # (4): memory: the resident estimate against an engine like the
    # served one, built and initialised.
    from shadow1_tpu_torch.fleet.engine import FleetEngine

    est = mem.estimate(exps[0], params, fleet=(exps, None))
    base_r = clean_allocator(dev)
    eng = FleetEngine(exps, params, device=dev)
    st = eng.init_state()
    sync(dev)
    resident = torch.cuda.memory_allocated(dev) - base_r
    ratio = est.resident_bytes / resident
    require(abs(ratio - 1) <= mem.AUDIT_TOLERANCE,
            f"served tgen50k: mem.estimate {est.resident_bytes} B vs "
            f"{resident} B allocated after init_state (ratio {ratio:.3f})")
    # Between the batches the daemon keeps only the cached engine's ctx
    # tables: a batch's state or a clone left alive would show here.
    leftover = before - base
    require(leftover <= est.planes["const"] + LEFTOVER_SLACK,
            f"served tgen50k: {leftover} B stay allocated between the "
            f"batches, over the cached engine's ctx tables "
            f"({est.planes['const']} B) and {LEFTOVER_SLACK} B of slack")
    est_peak = est.peak_bytes - est.planes["const"]
    require(est_peak >= peak["allocated"],
            f"served tgen50k: mem.estimate's peak {est_peak} B (its ctx "
            f"tables aside) is below the swapped batch's measured "
            f"{peak['allocated']} B")
    del st, eng
    return dict(b1=b1, b2=b2, solo=solo, launches=launches,
                push_entries=entries, kernels=kernels, actives=actives,
                build_s=build_s[0], rebind_s=rebind_s, saves=probe.saves,
                batch_saves=n_saves,
                budget=(budget0, budget_in, budget1), resident=resident,
                est_resident=est.resident_bytes, peak=peak,
                est_peak=est_peak, leftover=leftover,
                est_const=est.planes["const"],
                hosts=2 * exps[0].n_hosts, count_s=cw.wall_s,
                **cw.costs)


def _bare(rows) -> list:
    """Ring rows without the lane and job tags (a solo run's form)."""
    return [{k: v for k, v in r.items() if k not in ("exp", "job")}
            for r in rows]


def serve_probe() -> dict:
    """Step (b): ``tools/serveprobe.py`` with every gate, against the
    port's ``serve`` and ``submit`` entry points on the card."""
    import torch

    cfg = SERVE_DIR / "serve_phold.json"
    over = SERVE_DIR / "mem_overbudget.json"
    cfg.write_text(json.dumps(SERVE_PHOLD_DOC))
    over.write_text(json.dumps(OVERBUDGET_DOC))
    torch.cuda.empty_cache()  # the daemons are other processes
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "shadow1_tpu_torch.tools.serveprobe",
         str(cfg), "--seeds", "5,6", "--overbudget", str(over),
         "--resilience"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in r.stderr.splitlines():
        if line.startswith("[serveprobe]"):
            log(f"  {line}")
    require(r.returncode == 0, f"serveprobe failed (rc {r.returncode}): "
            f"{r.stdout[-1500:]} {r.stderr[-1500:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    require(out["ok"] and out["rejected_overbudget"]
            and out["resilience"]["bit_exact_jobs"] == 3
            and out["preemption"]["bit_exact_jobs"] == 3,
            f"serveprobe: {out}")
    return dict(out, wall_s=wall)


# -- phase 17: the operator tools --------------------------------------------

TOOLS_DIR = ROOT / "build" / "s17"
# configs/rung3_tor1k.yaml as JSON (faultprobe's tor probe on the card).
TOR1K_DOC = {
    "general": {"seed": 33, "stop_time": "60 s"},
    "engine": {"scheduler": "tpu", "ev_cap": 256, "sockets_per_host": 64,
               "msgq_cap": 64, "max_rounds": 1024, "compact_cap": 384},
    "network": {"single_vertex": {"latency": "30 ms"}},
    "hosts": [{"name": n, "count": c, "bandwidth_up": b, "bandwidth_down": b}
              for n, c, b in (("guard", 30, "100 Mbit"),
                              ("middle", 60, "100 Mbit"),
                              ("exit", 30, "100 Mbit"),
                              ("dirauth", 5, "100 Mbit"),
                              ("client", 875, "20 Mbit"))],
    "app": {"model": "tor", "params": {"ct_cap": 512, "cells_max": 120},
            "defaults": {"mean_stream_cells": 40, "mean_think_ns": "2 s",
                         "start_time": "100 ms"},
            "groups": {"guard": {"role": 0, "relay_weight": 300,
                                 "is_guard": True},
                       "middle": {"role": 0, "relay_weight": 200},
                       "exit": {"role": 0, "relay_weight": 250,
                                "is_exit": True},
                       "dirauth": {"role": 2},
                       "client": {"role": 1, "n_circuits": 3,
                                  "n_streams": 3}}},
}
# configs/rung1_filexfer.yaml as JSON; its GraphML path is made absolute
# when the file is written (``tool_configs``).
RUNG1_DOC = {
    "general": {"seed": 11, "stop_time": "20 s"},
    "engine": {"scheduler": "tpu", "ev_cap": 128},
    "network": {"graphml": "configs/topology_2pop.graphml"},
    "hosts": [{"name": "server", "count": 1, "vertex": "pop_west",
               "bandwidth_up": "10 Mbit", "bandwidth_down": "10 Mbit"},
              {"name": "client", "count": 1, "vertex": "pop_east",
               "bandwidth_up": "10 Mbit", "bandwidth_down": "10 Mbit"}],
    "app": {"model": "filexfer",
            "groups": {"server": {"role": 0},
                       "client": {"role": 1, "server": "@server",
                                  "flow_bytes": 1000000, "flow_count": 1,
                                  "start_time": "1 ms"}}},
}
# configs/sweep_phold.yaml's variants, in its order.
SWEEP_VARIANTS = (
    {}, {"network": {"single_vertex": {"loss": 0.02}}},
    {"network": {"single_vertex": {"loss": 0.10}}},
    {"faults": {"hosts": [{"group": "h", "down_at": "50 ms",
                           "up_at": "100 ms"}]}})
# Step (b): memprobe --subbatch's lanes per batch (17 lanes: 9 + 8).
SUBBATCH_LANES = 9
# Step (c): chaosprobe's windows and chunk; the solo trials (4: the four
# special kinds; a random fifth gave its time to the straight run's oracle
# cross-check and phase 18) and the fleet matrix's (2: drain and
# torn_head, from an under-sized ev_cap under --on-overflow retry). The
# three chaosprobe runs go side by side, each running its trials at once
# after its straight run (--jobs): a launch is a supervisor and a child
# that each start torch and reach the card, and a rung1 launch runs
# nearly all of the golden's 1,683 rounds in its 40 windows.
CHAOS_WINDOWS, CHAOS_CHUNK = 40, 10
CHAOS_SOLO_TRIALS = 4
CHAOS_FLEET_TRIALS, CHAOS_FLEET_CAP = 2, 4
CHAOS_FLEET_WINDOWS, CHAOS_FLEET_CHUNK = 20, 5
# Step (d): the CLI run beside them whose records give the reports'
# memory section: rung1 under --on-overflow retry with a SHADOW1_MEM_BYTES
# budget between its halt and retry peaks, so --on-oom downshift must drop
# the rollback copy.
MEMRUN_ARGS = ("--windows", "4", "--heartbeat", "2", "--on-overflow",
               "retry", "--on-oom", "downshift")


def sweep17_doc(**engine) -> dict:
    """configs/sweep_phold.yaml as the 17 lanes of
    golden/fleet_sweep_phold.json (``config.compiled
    .sweep_phold_experiments``), in JSON: every seed under every variant,
    seed-major, then seed 1 held to 2 rounds a window; ``engine``
    overrides engine params."""
    from shadow1_tpu_torch.config.compiled import SWEEP_PHOLD_SEEDS as seeds

    return {
        "general": {"seed": 1, "stop_time": "200 ms"},
        "engine": {"scheduler": "tpu", "ev_cap": 64, "outbox_cap": 32,
                   **engine},
        "network": {"single_vertex": {"latency": "10 ms"}},
        "hosts": [{"name": "h", "count": 64}],
        "app": {"model": "phold",
                "params": {"mean_delay_ns": 2.0e7, "init_events": 2}},
        "sweep": {"seeds": [s for s in seeds for _ in SWEEP_VARIANTS]
                  + [seeds[0]],
                  "vary": [v for _ in seeds for v in SWEEP_VARIANTS]
                  + [{"engine": {"max_rounds": 2}}]},
    }


def tool_configs() -> dict:
    """Write the JSON mirrors phase 17 runs; name → path."""
    rung1 = json.loads(json.dumps(RUNG1_DOC))
    rung1["network"]["graphml"] = str(ROOT / RUNG1_DOC["network"]["graphml"])
    # configs/dense_tgen50k.yaml: phase 16's tenant at the config's own
    # horizon, without the digest words.
    dense = json.loads(json.dumps(TGEN50K_DOC))
    dense["general"]["stop_time"] = "20 s"
    del dense["engine"]["state_digest"]
    docs = {"tor1k": TOR1K_DOC, "rung1": rung1, "sweep17": sweep17_doc(),
            "sweep17_small": sweep17_doc(ev_cap=CHAOS_FLEET_CAP),
            "dense_tgen50k": dense, "serve_phold": SERVE_PHOLD_DOC}
    paths = {}
    for name, doc in docs.items():
        paths[name] = str(TOOLS_DIR / f"{name}.json")
        Path(paths[name]).write_text(json.dumps(doc))
    return paths


def start_tool(name: str, module: str, *args, env=None) -> tuple:
    """``python -m shadow1_tpu_torch.tools.<module> args`` (``module``
    "" for the CLI) on the card (no --device: the default), stdout and
    stderr to files; ``env`` adds to the environment."""
    out = TOOLS_DIR / f"{name}.out"
    with open(out, "w") as fo, open(f"{out}.err", "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             ".".join(["shadow1_tpu_torch"] + (["tools", module] if module
                                               else [])), *args],
            cwd=ROOT, env={**os.environ, **(env or {})}, stdout=fo,
            stderr=fe)
    return name, proc, out, time.perf_counter()


def finish_tools(tools, timeout: float) -> dict:
    """Wait for ``start_tool`` processes: name → (its JSON lines, its
    wall from start to exit)."""
    out, pending = {}, list(tools)
    deadline = time.perf_counter() + timeout
    while pending:
        for tool in list(pending):
            name, proc, path, t0 = tool
            rc = proc.poll()
            if rc is None:
                continue
            pending.remove(tool)
            text = Path(path).read_text()
            require(rc == 0, f"phase 17: {name} exited {rc}: {text[-1500:]} "
                    f"{Path(f'{path}.err').read_text()[-1500:]}")
            out[name] = ([json.loads(s) for s in text.splitlines()
                          if s.startswith("{")], time.perf_counter() - t0)
        if pending and time.perf_counter() > deadline:
            for _, proc, _, _ in pending:
                proc.kill()
                proc.wait()
            raise AssertionError(f"phase 17: {[t[0] for t in pending]} ran "
                                 f"past {timeout} s")
        time.sleep(0.1)
    return out


def tools_faultprobe(dev, paths) -> dict:
    """Step (a): faultprobe on the card, alone, then its pop probe in
    process against the plain versions on the same inputs."""
    from shadow1_tpu_torch.core.events import pop_until_plain, push_local_plain
    from shadow1_tpu_torch.tools import faultprobe

    (lines, wall), = finish_tools([start_tool(
        "faultprobe", "faultprobe", "sort0", "scan0", "pop", "phold", "tor",
        "10", "--tor-config", paths["tor1k"])], timeout=300).values()
    head, probes = lines[0], {r["probe"]: r for r in lines[1:]}
    require(head["backend"] == "cuda" and head["device"].startswith("cuda"),
            f"faultprobe ran on {head}")
    require(list(probes) == ["sort0", "scan0", "pop", "phold", "tor"]
            and all(r["ok"] for r in probes.values()),
            f"faultprobe: {lines}")
    need = {"pop": ("pop", "push"), "phold": ("pop", "push", "obox"),
            "tor": ("pop", "push", "obox")}
    for probe, kernels in need.items():
        got = probes[probe]["launches"]
        require(all(got[k] > 0 for k in kernels),
                f"faultprobe {probe}: kernels not launched: {got}")
    buf, ev = faultprobe.pop_probe(dev)
    b0, mask, t, kind, p, until = faultprobe.pop_inputs(dev)
    b0, _ = push_local_plain(b0, mask, t, kind, p)
    ref_buf, ref_ev = pop_until_plain(b0, until)
    err = max(bit_equal("faultprobe pop: buffer", ref_buf, buf),
              bit_equal("faultprobe pop: popped event", ref_ev, ev))
    return dict(head=head, probes=probes, wall_s=wall, pop_err=err)


def tools_memprobe(dev, paths) -> dict:
    """Step (b) in process: --maxfit against the card's budget (before the
    step (c) processes hold memory), --audit of fidelity16k (built in code:
    it has no config file) and of dense_tgen50k's mirror, and --subbatch
    on the 17-lane sweep mirror, each lane's stream against the golden."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.tools import memprobe

    gold = net_golden("fidelity16k")
    exp, params = net_experiment("fidelity16k", gold), fid_params(gold)
    clean_allocator(dev)
    budget, source = mem.device_budget(dev)
    require(source == "backend", f"the card's budget: {source}")
    t0 = time.perf_counter()
    fit = [memprobe.maxfit_experiment("fidelity16k", exp, params, budget),
           memprobe.maxfit(paths["sweep17"], budget)]
    fit_s = time.perf_counter() - t0
    require(fit[0]["max_hosts"] >= exp.n_hosts and fit[1]["sweep_lanes"] == 17
            and fit[1]["max_lanes"] == 17
            and fit[1]["max_lanes_linear"] >= 17, f"memprobe --maxfit: {fit}")
    return dict(budget=budget, maxfit=fit, maxfit_s=fit_s, exp=exp,
                params=params)


def tools_memprobe_runs(dev, paths, mp) -> dict:
    """Step (b)'s runs, while step (c)'s processes run: the audits and the
    sub-batch proof (its launches counted from 0: this step's path)."""
    from shadow1_tpu_torch.core import popk
    from shadow1_tpu_torch.tools import memprobe

    t0 = time.perf_counter()
    audit = [memprobe.audit_experiment("fidelity16k", mp["exp"],
                                       mp["params"], None, dev),
             memprobe.audit_config(paths["dense_tgen50k"], device=dev)]
    audit_s = time.perf_counter() - t0
    require(all(r["ok"] for r in audit), f"memprobe --audit: {audit}")
    clean_allocator(dev)
    gold = fleet_golden()
    zero_counts()
    t0 = time.perf_counter()
    verdict, streams = memprobe.subbatch_run(
        paths["sweep17"], SUBBATCH_LANES, None, lambda msg: None, dev)
    sub_s = time.perf_counter() - t0
    launches = dict(popk.LAUNCHES)
    require(all(n > 0 for n in launches.values()),
            f"memprobe --subbatch: kernels not launched: {launches}")
    require(verdict["ok"] and verdict["experiments"] == 17
            and verdict["ckpt_cycled"], f"memprobe --subbatch: {verdict}")
    for e, lane in enumerate(gold["lanes"]):
        got = [list(streams[e][w]) for w in sorted(streams[e])]
        require(got == lane["digests"], f"memprobe --subbatch: lane {e}'s "
                f"digest words differ from the golden's")
    return dict(audit=audit, audit_s=audit_s, subbatch=verdict,
                subbatch_s=sub_s, launches=launches)


def memrun_budget(paths) -> int:
    """Step (d): a byte budget between the memory run's halt and retry
    peaks (``mem.estimate`` of the params its flags give)."""
    import dataclasses

    from shadow1_tpu_torch import cli, mem
    from shadow1_tpu_torch.config.experiment import load_experiment

    ap = cli._parser()
    args = ap.parse_args([paths["rung1"], *MEMRUN_ARGS])
    exp, params, _ = load_experiment(paths["rung1"])
    params = cli._params(ap, args, exp, params)
    retry = mem.estimate(exp, params).peak_bytes
    halt = mem.estimate(exp, dataclasses.replace(
        params, on_overflow="halt")).peak_bytes
    require(halt < retry, f"memory run: halt {halt} B, retry {retry} B")
    return (halt + retry) // 2


def launch_log(paths, name: str) -> str:
    """The CLI launches' record streams (stdout, then stderr, launch by
    launch) joined into TOOLS_DIR / ``name``."""
    path = TOOLS_DIR / name
    path.write_text("".join(Path(p).read_text() for out in paths
                            for p in (out, f"{out}.err")))
    return str(path)


def tools_reports() -> dict:
    """Step (d): the four reports over the record streams the program
    wrote on the card: phase 13's split fidelity16k run (heartbeats, ring,
    flow and link records), the solo chaosprobe's CLI launches (lineage:
    resumes, the drain), the memory run (its estimate, downshift and
    final peak) and phase 16's daemon (``serve.log``); each exits 0, and
    the lineage, memory, serve, flow and link sections are there and not
    empty."""
    import contextlib
    import io

    from shadow1_tpu_torch.tools import (
        captune,
        flowreport,
        heartbeat_report,
        netreport,
    )

    solo = TOOLS_DIR / "chaos_solo"
    logs = {"obs": str(OBS_RECORDS),
            "chaos": launch_log(sorted(solo.glob("t*_l*.out")),
                                "chaos_solo.log"),
            "mem": launch_log([TOOLS_DIR / "memrun.out"], "memrun.log"),
            "serve": str(SERVE_DIR / "spool" / "serve.log")}
    runs = [(heartbeat_report, [logs[k]]) for k in logs] + [
        (flowreport, [logs["obs"]]), (netreport, [logs["obs"]]),
        (captune, [logs["obs"], logs["mem"]])]
    out = {}
    t0 = time.perf_counter()
    for module, argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = module.main(argv)
        name = module.__name__.rsplit(".", 1)[-1]
        require(rc == 0 and buf.getvalue().strip(),
                f"{name} {argv}: rc {rc}")
        out[f"{name} {Path(argv[0]).name}"] = len(buf.getvalue())
    recs = [r for k in logs for r in heartbeat_report.load_records(logs[k])]
    summary = heartbeat_report.summarize(recs, out=io.StringIO())
    wall = time.perf_counter() - t0
    for k in ("lineage", "memory", "serve", "flows", "links"):
        require(summary.get(k), f"heartbeat_report: no {k} section")
    lin = summary["lineage"]
    ms = heartbeat_report.summarize(heartbeat_report.load_records(
        logs["mem"]), out=io.StringIO()).get("memory", {})
    require(lin["resumes"] >= 2 and lin["preempted_drains"] >= 1,
            f"heartbeat_report lineage: {lin}")
    require([d["action"] for d in ms.get("downshifts", [])]
            == ["drop_rollback"] and ms.get("peak_in_use", 0) > 0,
            f"heartbeat_report memory of the memory run: {ms}")
    return dict(chars=out, wall_s=wall, lineage=lin,
                memory={k: ms.get(k) for k in ("estimated_peak",
                                               "peak_in_use", "downshifts")},
                serve=summary["serve"], flows=len(summary["flows"]),
                links=summary["links"])


def chaos_stream(work: Path) -> list:
    """The straight run's ring rows of a chaosprobe run kept in ``work``."""
    return [json.loads(s) for s in (work / "ref.out").read_text().splitlines()
            if s.startswith('{"type": "ring"')]


def tools_chaos_start(paths) -> list:
    """Steps (c) and (d): start the chaosprobe runs and the memory run
    (``start_tool``); the solo chaosprobe keeps its launches' files in
    TOOLS_DIR / "chaos_solo"."""
    return [
        start_tool("chaos_solo", "chaosprobe", paths["rung1"],
                   "--trials", str(CHAOS_SOLO_TRIALS), "--jobs",
                   str(CHAOS_SOLO_TRIALS), "--windows",
                   str(CHAOS_WINDOWS), "--chunk", str(CHAOS_CHUNK), "--seed",
                   "1", "--work", str(TOOLS_DIR / "chaos_solo"),
                   "--json-only"),
        start_tool("chaos_fleet", "chaosprobe", paths["sweep17_small"],
                   "--fleet", "--no-oracle", "--extra", "--on-overflow retry",
                   "--trials", str(CHAOS_FLEET_TRIALS), "--jobs",
                   str(CHAOS_FLEET_TRIALS), "--windows",
                   str(CHAOS_FLEET_WINDOWS), "--chunk",
                   str(CHAOS_FLEET_CHUNK), "--json-only"),
        start_tool("chaos_serve", "chaosprobe", paths["serve_phold"],
                   "--serve", "1", "--seed", "3", "--json-only"),
        start_tool("memrun", "", paths["rung1"], *MEMRUN_ARGS,
                   env={"SHADOW1_MEM_BYTES": str(memrun_budget(paths))})]


def tools_chaos_verdicts(chaos) -> tuple:
    """Step (c): wait for the chaosprobe runs and the memory run and hold
    the chaosprobe verdicts: each ok with every trial of its kinds; the
    solo straight stream equal to ``net_rung1.json``'s windows; every
    fleet lane's rows; the serve trial no torn record. (Name → verdict,
    with its wall; the memory run's wall.)"""
    done = finish_tools(chaos, timeout=600)
    lines, memrun_s = done.pop("memrun")
    require("metrics" in lines[-1], f"memory run: {lines[-1:]}")
    verdicts = {}
    for name, (lines, wall) in done.items():
        verdicts[name] = v = dict(lines[-1], wall_s=wall)
        require(v["ok"], f"phase 17: {name}: {v}")
    solo, fl, sv = (verdicts[k] for k in ("chaos_solo", "chaos_fleet",
                                          "chaos_serve"))
    kinds = solo["kinds"]
    require(solo["oracle_checked"] is True and not solo["fleet"]
            and solo["trials"] == CHAOS_SOLO_TRIALS
            and all(kinds.get(k) == 1 for k in ("drain", "torn_head",
                                                "corrupt_head", "mid_write"))
            and sum(kinds.values()) == CHAOS_SOLO_TRIALS
            and solo["preempted_exits"] >= 1
            and solo["lineage_fallbacks"] >= 1, f"chaos_solo: {solo}")
    check_digests("chaosprobe rung1 straight run", net_golden("rung1"),
                  chaos_stream(TOOLS_DIR / "chaos_solo"), 0, CHAOS_WINDOWS)
    require(fl["fleet"] and fl["trials"] == CHAOS_FLEET_TRIALS
            and fl["digest_rows"] == 17 * CHAOS_FLEET_WINDOWS,
            f"chaos_fleet: {fl}")
    require(sv["torn_records"] == [] and sv["trials"] == 1,
            f"chaos_serve: {sv}")
    return verdicts, memrun_s


def phase_tools(dev, card: str) -> dict:
    """Phase 17, the operator tools, its steps' wall times printed."""
    import shutil

    step_s = {}

    def step(name, t0):
        step_s[name] = time.perf_counter() - t0
        log(f"  tools step {name}: {step_s[name]:.1f} s wall")

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    paths = tool_configs()

    t0 = time.perf_counter()
    mp = tools_memprobe(dev, paths)
    for r in mp["maxfit"]:
        log(f"memprobe --maxfit {Path(r['config']).name} at the card's "
            f"budget {r['budget']} B on {card}: {r['hosts']} hosts need "
            f"{r['estimated_peak']} B, at most {r['max_hosts']} hosts"
            + (f"; {r['sweep_lanes']} lanes, at most {r['max_lanes']} of "
               f"them ({r['lane_bytes']} B a lane, {r['max_lanes_linear']} "
               f"lanes by the linear envelope)" if "max_lanes" in r else "")
            + f" ({mp['maxfit_s']:.1f} s for both)")
    step("(b) memprobe --maxfit", t0)

    t0 = time.perf_counter()
    fp = tools_faultprobe(dev, paths)
    pr = fp["probes"]
    log(f"faultprobe on {fp['head']['name']} ({fp['head']['device']}): "
        + ", ".join(f"{k} ok {r['wall_s']} s" for k, r in pr.items())
        + f"; PHOLD probe (1,000 hosts, ev_cap 256) "
        f"{pr['phold']['ms_per_round']} ms/round over {pr['phold']['rounds']}"
        f" rounds; tor 10 windows {pr['tor']['events']} events; launches "
        f"{ {k: r['launches'] for k, r in pr.items()} }; the pop probe's "
        f"buffer and popped event bit-equal to pop_until_plain / "
        f"push_local_plain; {fp['wall_s']:.1f} s in all")
    step("(a) faultprobe", t0)

    t0 = time.perf_counter()
    chaos = tools_chaos_start(paths)
    runs = tools_memprobe_runs(dev, paths, mp)
    for r in runs["audit"]:
        log(f"memprobe --audit {Path(r['config']).name} on {card}: resident "
            f"estimate {r['estimated_resident']} B vs {r['measured_live']} B "
            f"allocated (ratio {r['ratio']}), ok")
    sb = runs["subbatch"]
    log(f"memprobe --subbatch sweep17 ({sb['experiments']} lanes, "
        f"{sb['windows']} windows, batches of {sb['lanes_per_batch']} through "
        f"a snapshot at window {sb['windows'] // 2}): every lane's digest "
        f"stream and parity metrics bit-identical to the full fleet's and "
        f"every lane equal to golden/fleet_sweep_phold.json; launches "
        f"{runs['launches']}; audit {runs['audit_s']:.1f} s, subbatch "
        f"{runs['subbatch_s']:.1f} s")
    verdicts, memrun_s = tools_chaos_verdicts(chaos)
    for name, v in sorted(verdicts.items()):
        if name == "chaos_serve":
            what = (f"{[t['kind'] for t in v['verdicts']]}, "
                    f"{sum(t['windows_compared'] for t in v['verdicts'])} "
                    f"windows compared with solo, no torn record")
        else:
            what = (f"{v['kinds']}, {v['launches']} launches, "
                    f"{v['preempted_exits']} drain(s), "
                    f"{v['lineage_fallbacks']} lineage fallback(s), "
                    f"{v['digest_rows']} digest rows, straight run "
                    f"{v['straight_wall_s']} s")
        log(f"chaosprobe {name} on {card}: ok, {what}; {v['wall_s']:.1f} s "
            f"wall (the three runs and the memory run side by side)")
    log(f"chaosprobe rung1 straight run equal to golden/net_rung1.json "
        f"windows 0-{CHAOS_WINDOWS - 1}")
    rep = tools_reports()
    log(f"reports over the records of phase 13's split run, the solo "
        f"chaosprobe's CLI launches, the memory run ({memrun_s:.1f} s wall) "
        f"and phase 16's daemon: {rep['chars']} characters printed, every "
        f"one exit 0; lineage {rep['lineage']}, memory {rep['memory']}, "
        f"serve jobs {rep['serve']['jobs']} batches "
        f"{rep['serve']['batches']}, {rep['flows']} flows, links "
        f"{rep['links']} ({rep['wall_s']:.1f} s)")
    step("(b)-(d) memprobe, chaosprobe, reports", t0)
    return dict(faultprobe=fp, memprobe=dict(mp, **runs), reports=rep,
                chaos=verdicts, memrun_s=memrun_s, step_s=step_s)


# -- phase 5: the kernels on the arguments of the main path -----------------

# -- phase 18: the oracle and the comparator -----------------------------

ORACLE_DIR = ROOT / "build" / "s18"
# configs/rung4_tor10k.yaml as JSON: activeprobe and depthprobe run the
# oracle on it for ORACLE_PROBE_WINDOWS windows (tor10k's golden depth).
TOR10K_DOC = {
    "general": {"seed": 44, "stop_time": "60 s"},
    "engine": {"scheduler": "tpu", "ev_cap": 256, "sockets_per_host": 128,
               "msgq_cap": 64, "max_rounds": 1024, "compact_cap": 1280},
    "network": {"single_vertex": {"latency": "30 ms"}},
    "hosts": [{"name": n, "count": c, "bandwidth_up": b, "bandwidth_down": b}
              for n, c, b in (("guard", 300, "200 Mbit"),
                              ("middle", 500, "200 Mbit"),
                              ("exit", 200, "200 Mbit"),
                              ("dirauth", 10, "200 Mbit"),
                              ("client", 8990, "20 Mbit"))],
    "app": {"model": "tor", "params": {"ct_cap": 1024, "cells_max": 120},
            "defaults": {"mean_stream_cells": 40, "mean_think_ns": "5 s",
                         "start_time": "200 ms"},
            "groups": {"guard": {"role": 0, "relay_weight": 300,
                                 "is_guard": True},
                       "middle": {"role": 0, "relay_weight": 200},
                       "exit": {"role": 0, "relay_weight": 250,
                                "is_exit": True},
                       "dirauth": {"role": 2},
                       "client": {"role": 1, "n_circuits": 2,
                                  "n_streams": 3,
                                  "start_time": {"start": "200 ms",
                                                 "interval": "2 ms"}}}},
}
ORACLE_PROBE_WINDOWS = 40
# pcapdump on rung1: one --host and one --edge capture of its first 20
# windows (the handshake and the first flow's data in both directions).
PCAP_RUNS = {"host": ("--windows", "20", "--host", "client"),
             "edge": ("--windows", "20", "--edge", "pop_west:pop_east")}
# occprobe on dense_tgen50k at its full width: 20 windows, in chunks of 5.
OCC_ARGS = ("--windows", "20", "--step", "5")
# fleetprobe: configs/sweep_phold.yaml's 4 lanes against their solo runs
# on both sides; the same sweep at ev_cap CHAOS_FLEET_CAP under --retry
# (grown to 8), both sides; and phase 17's 17-lane sweep at that cap under
# --retry, where the oracle side differs in 3 lanes as the reference's
# does (two overflow at the grown cap 8: the oracle pushes an arrival at
# once, the batched engines at the window's end; one is held to 2 rounds
# a window, which the oracle does not model). Each verdict must equal the
# reference's; those marked True must be ok.
_RETRY = ("--retry", "--sides", "tpu,cpu", "--windows",
          str(CHAOS_FLEET_WINDOWS), "--chunk", str(CHAOS_FLEET_CHUNK))
FLEETPROBE_RUNS = {
    "sides": ("sweep_phold", ("--sides", "tpu,cpu"), True),
    "retry": ("sweep_phold_small", _RETRY, True),
    "retry17": ("sweep17_small", _RETRY, False),
}
# The oracle's full-width runs (net goldens) and the comparator's.
ORACLE_RUNS = ("tor10k", "bitcoin5k")
NATIVE_NET_RUNS = ("filexfer16k", "tgen50k", "tor10k", "bitcoin5k")
ORACLE_CLI_WINDOWS = 40
# The comparator's thread counts at bench PHOLD beside os.cpu_count().
NATIVE_THREADS = 16


def sweep_phold_doc(**engine) -> dict:
    """configs/sweep_phold.yaml in JSON (4 seeds, one variant each)."""
    return {
        "general": {"seed": 1, "stop_time": "200 ms"},
        "engine": {"scheduler": "tpu", "ev_cap": 64, "outbox_cap": 32,
                   **engine},
        "network": {"single_vertex": {"latency": "10 ms"}},
        "hosts": [{"name": "h", "count": 64}],
        "app": {"model": "phold",
                "params": {"mean_delay_ns": 2.0e7, "init_events": 2}},
        "sweep": {"seeds": [1, 2, 3, 4], "vary": list(SWEEP_VARIANTS)},
    }


def oracle_configs(out_dir: Path = None) -> dict:
    """Write the JSON mirrors phase 18 runs (``tools/torch_golden.py``
    writes the reference's rows from the same files); name → path."""
    out_dir = Path(out_dir or ORACLE_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    rung1 = json.loads(json.dumps(RUNG1_DOC))
    rung1["network"]["graphml"] = str(ROOT / RUNG1_DOC["network"]["graphml"])
    dense = json.loads(json.dumps(TGEN50K_DOC))
    dense["general"]["stop_time"] = "20 s"
    del dense["engine"]["state_digest"]
    docs = {"rung1": rung1, "tor10k": TOR10K_DOC,
            "dense_tgen50k": dense, "sweep_phold": sweep_phold_doc(),
            "sweep_phold_small": sweep_phold_doc(ev_cap=CHAOS_FLEET_CAP),
            "sweep17_small": sweep17_doc(ev_cap=CHAOS_FLEET_CAP)}
    paths = {}
    for name, doc in docs.items():
        paths[name] = str(out_dir / f"{name}.json")
        Path(paths[name]).write_text(json.dumps(doc))
    return paths


class NativeBuild:
    """Both comparators built with g++ from the checkout's sources, in
    threads started with the script (beside nvcc), each timed; ``join``
    raises the first build's error: a failed build fails phase 18."""

    def __init__(self):
        import threading

        from shadow1_tpu_torch import native

        self.seconds, self.errors = {}, []

        def build(name, fn):
            t0 = time.perf_counter()
            try:
                fn(force=True)
            except Exception as e:  # noqa: BLE001 — re-raised by join
                self.errors.append(e)
            self.seconds[name] = time.perf_counter() - t0

        self.threads = [threading.Thread(target=build, args=a) for a in (
            ("phold", native.ensure_built),
            ("net", native.ensure_net_built))]
        for t in self.threads:
            t.start()

    def join(self) -> dict:
        for t in self.threads:
            t.join()
        if self.errors:
            raise self.errors[0]
        return self.seconds


def host_cpu() -> str:
    """The host's CPU model (``/proc/cpuinfo``'s model name, else
    ``lscpu``'s, else its vendor, family and model numbers) and logical
    core count."""
    known = lambda v: v and v.strip().lower() != "unknown"  # noqa: E731
    info = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, val = line.partition(":")
            info.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    model = info.get("model name", "")
    if not known(model):
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.lower().startswith("model name")), "")
    if not known(model):
        model = (f"{info.get('vendor_id', '?')} family "
                 f"{info.get('cpu family', '?')} model {info.get('model', '?')}"
                 f" stepping {info.get('stepping', '?')} (no model name)")
    return f"{model}, {os.cpu_count()} logical cores"


def oracle_native(cuda: dict) -> dict:
    """Step (a): the comparator on bench PHOLD (os.cpu_count() threads and
    NATIVE_THREADS) and on the net goldens, its counters equal to the
    goldens (and, for PHOLD, to the CUDA bench run), its wall beside the
    CUDA engine's run of the same config and windows (``cuda``)."""
    from shadow1_tpu_torch import native
    from shadow1_tpu_torch.consts import EngineParams

    gold = json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / "phold_bench.json").read_text())
    cfg = gold["config"]
    keys = ("events", "pkts_sent", "pkts_delivered", "ev_overflow",
            "ob_overflow")
    out = {}
    for threads in (os.cpu_count(), NATIVE_THREADS):
        r = native.run_phold(
            n_hosts=cfg["n_hosts"], seed=cfg["seed"],
            n_windows=cfg["windows"], window_ns=cfg["latency_ns"],
            mean_delay_ns=cfg["mean_delay_ns"],
            init_events=cfg["init_events"], ev_cap=cfg["ev_cap"],
            outbox_cap=cfg["outbox_cap"], n_threads=threads)
        for k in keys:
            require(r[k] == gold["metrics"][k] == cuda["bench"]["metrics"][k],
                    f"comparator bench PHOLD ({threads} threads): {k} "
                    f"{r[k]}, golden {gold['metrics'][k]}, CUDA "
                    f"{cuda['bench']['metrics'][k]}")
        out[f"bench/{threads}"] = r
    for name in NATIVE_NET_RUNS:
        g = net_golden(name)
        exp = net_experiment(name, g)
        r = native.run_net(exp, EngineParams(**g["params"]), g["windows"])
        for k in ("events", "pkts_sent", "pkts_delivered"):
            require(r[k] == g["metrics"][k], f"comparator {name}: {k} "
                    f"{r[k]}, golden {g['metrics'][k]}")
        out[name] = r
    return out


def oracle_full_width() -> dict:
    """The numpy oracle at full width on ORACLE_RUNS, held to each golden
    in every Metrics field it keeps, every summary sum and per-host
    SHA-256 and every digest word."""
    import numpy as np

    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.cpu_engine import CpuEngine

    out = {}
    for name in ORACLE_RUNS:
        g = net_golden(name)
        exp = net_experiment(name, g)
        params = EngineParams(**g["params"], metrics_ring=g["windows"],
                              state_digest=1)
        t0 = time.perf_counter()
        eng = CpuEngine(exp, params)
        t1 = time.perf_counter()
        m = eng.run(n_windows=g["windows"])
        t2 = time.perf_counter()
        diff = {k: (g["metrics"].get(k), v) for k, v in m.items()
                if g["metrics"].get(k) != v}
        require(not diff, f"oracle {name}: metrics differ from the golden "
                f"(golden, oracle): {diff}")
        summ = eng.summary()
        got = {k: int(np.asarray(summ[k]).sum()) for k in g["summary"]}
        require(got == g["summary"], f"oracle {name}: summary {got}")
        for k, want in g["sha256"].items():
            h = hashlib.sha256(np.asarray(summ[k], "<i8").tobytes())
            require(h.hexdigest() == want,
                    f"oracle {name}: per-host {k} differs from the golden")
        check_digests(f"oracle {name}", g, [dict(r, type="ring")
                                            for r in eng.digest_rows],
                      0, g["windows"])
        out[name] = dict(build_s=t1 - t0, run_s=t2 - t1, hosts=exp.n_hosts,
                         events=m["events"], windows=g["windows"],
                         metrics=len(m))
    return out


def oracle_cli_rung1(paths) -> dict:
    """``python -m shadow1_tpu_torch --engine cpu`` on rung1, in process:
    its wall and its stderr digest rows."""
    import contextlib
    import io

    from shadow1_tpu_torch import cli

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as so, \
            contextlib.redirect_stderr(err):
        rc = cli.main([paths["rung1"], "--engine", "cpu", "--windows",
                       str(ORACLE_CLI_WINDOWS), "--state-digest", "on"])
    res = json.loads(so.getvalue().strip().splitlines()[-1])
    require(rc == 0 and res["engine"] == "cpu"
            and res["windows"] == ORACLE_CLI_WINDOWS,
            f"--engine cpu on rung1: rc {rc}, {res}")
    return dict(wall_s=time.perf_counter() - t0,
                events=res["metrics"]["events"],
                rows=[json.loads(s) for s in err.getvalue().splitlines()
                      if s.startswith('{"type": "digest"')])


def _tool_main(module, argv) -> tuple:
    """``module.main(argv)`` in process: (rc, stdout lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue().strip().splitlines()


def oracle_tools_golden() -> dict:
    return json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / "oracle_tools.json").read_text())


def oracle_host_tools(paths, step_s: dict) -> dict:
    """The tools on the oracle (pcapdump on rung1; activeprobe and
    depthprobe on tor10k's mirror), each against the reference's rows in
    ``golden/oracle_tools.json``."""
    from shadow1_tpu_torch.tools import activeprobe, depthprobe, pcapdump

    gold = oracle_tools_golden()
    out = {}
    t0 = time.perf_counter()
    for case, args in PCAP_RUNS.items():
        pcap = ORACLE_DIR / f"{case}.pcap"
        rc, _ = _tool_main(pcapdump, [paths["rung1"], str(pcap), *args])
        data = pcap.read_bytes()
        want = gold["pcap"][case]
        require(rc == 0 and list(args) == want["args"]
                and hashlib.sha256(data).hexdigest() == want["sha256"],
                f"pcapdump rung1 {case}: {len(data)} bytes, golden "
                f"{want['bytes']}")
        out[f"pcap_{case}"] = len(data)
    step_s["pcapdump"] = time.perf_counter() - t0
    for name, module in (("activeprobe", activeprobe),
                         ("depthprobe", depthprobe)):
        t0 = time.perf_counter()
        rc, lines = _tool_main(module, [paths["tor10k"], "--windows",
                                        str(ORACLE_PROBE_WINDOWS)])
        step_s[name] = time.perf_counter() - t0
        row = json.loads(lines[-1])
        row.pop("config")
        require(rc == 0 and row == gold[name]["row"],
                f"{name} tor10k: {row}, golden {gold[name]['row']}")
        out[name] = row
    return out


def oracle_host_child(out_path: str) -> None:
    """Phase 18's host-only work, in a process of its own started with the
    script (``OracleHostWork``): the oracle at full width, ``--engine
    cpu`` on rung1 and the host tools. Writes its results, or the error,
    as JSON to ``out_path``."""
    import traceback

    try:
        paths = oracle_configs()
        t0 = time.perf_counter()
        res = {"oracle": oracle_full_width()}
        res["oracle_s"] = time.perf_counter() - t0
        res["cli_rung1"] = oracle_cli_rung1(paths)
        res["step_s"] = {}
        res["tools"] = oracle_host_tools(paths, res["step_s"])
        res["cpu"] = host_cpu()
        res["census_cpu"] = attr_census_cpu()
    except BaseException:  # noqa: BLE001 — reported to the parent
        res = {"error": traceback.format_exc()}
    Path(out_path).write_text(json.dumps(res))


class OracleHostWork:
    """``oracle_host_child`` in a subprocess (no CUDA device visible: it
    runs on the host only), started after the kernels' build so that it
    overlaps the card phases; ``join`` waits for it and raises its error.
    It uses one core of the host beside the main process's."""

    def __init__(self):
        ORACLE_DIR.mkdir(parents=True, exist_ok=True)
        self.out = ORACLE_DIR / "host.json"
        self.out.unlink(missing_ok=True)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.oracle_host_child({str(self.out)!r})"],
            cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            stdout=subprocess.DEVNULL)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def join(self, timeout: float = 600) -> dict:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        waited = time.perf_counter() - self.t0
        require(rc == 0 and self.out.exists(),
                f"phase 18's host process exited {rc}")
        res = json.loads(self.out.read_text())
        require("error" not in res, f"phase 18's host work: "
                f"{res.get('error', '')[-3000:]}")
        res["since_start_s"] = waited
        return res


def oracle_card_tools(dev, paths) -> dict:
    """The tools on the card, in process, each run's launches counted from
    0 and every kernel launched: fleetprobe (``FLEETPROBE_RUNS``) and
    occprobe on dense_tgen50k at its full width, against the reference's
    verdicts and row in ``golden/oracle_tools.json``."""
    from shadow1_tpu_torch.tools import fleetprobe, occprobe

    gold = oracle_tools_golden()
    out, step_s = {}, {}

    def counted(name, module, argv):
        zero_counts()
        t0 = time.perf_counter()
        rc, lines = _tool_main(module, argv)
        step_s[name] = time.perf_counter() - t0
        launches = read_counts()
        require(all(launches[k] > 0 for k in ("pop", "push", "obox")),
                f"{name}: kernels not launched: {launches}")
        return rc, json.loads(lines[-1]), launches

    for case, (cfg, args, ok) in FLEETPROBE_RUNS.items():
        rc, v, n = counted(f"fleetprobe {case}", fleetprobe,
                           [paths[cfg], *args, "--json-only"])
        want = gold["fleetprobe"][case]
        require(list(args) == want["args"] and v == want["verdict"]
                and (rc == 0) == ok and v["ok"] is ok
                and not [m for m in v["mismatches"] if m["side"] == "tpu"],
                f"fleetprobe {case} ({cfg}): rc {rc}, {v}; the reference's "
                f"{want['verdict']}")
        if "--retry" in args:
            require(v["chunk_retries"] > 0, f"fleetprobe {case}: no retry")
        out[f"fleetprobe_{case}"] = dict(verdict=v, launches=n)
    rc, row, n = counted("occprobe", occprobe, [paths["dense_tgen50k"],
                                                *OCC_ARGS])
    row.pop("config")
    require(rc == 0 and row["ev_overflow"] == 0
            and row == gold["occprobe"]["row"],
            f"occprobe dense_tgen50k: rc {rc}, {row}, golden "
            f"{gold['occprobe']['row']}")
    out["occprobe"] = dict(row=row, launches=n)
    out["step_s"] = step_s
    return out


def phase_oracle(dev, card: str, cuda: dict, builds: NativeBuild,
                 host: OracleHostWork) -> dict:
    """Phase 18, the oracle and the comparator, its steps' wall printed.
    ``cuda``: the CUDA engine's runs of the same configs and windows in
    this call (name → run_golden / run_net_golden result); ``host``: the
    host-only work, running since the build."""
    from shadow1_tpu_torch.core.digest import DIGEST_FIELDS

    t0 = time.perf_counter()
    build_s = builds.join()
    log(f"comparator build (g++ -O2, in threads beside nvcc): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in build_s.items()))
    cpu = host_cpu()
    nat = oracle_native(cuda)
    for name, r in nat.items():
        base = name.split("/")[0]
        c = cuda[base]
        log(f"comparator {name}: {r['events']} events in {r['wall_s']} s = "
            f"{r['events_per_sec']} events/s ({r['n_threads']} threads on "
            f"{cpu}); the CUDA engine {c['events']} events in "
            f"{c['wall_s']:.3f} s = {c['events'] / c['wall_s']:.0f} events/s "
            f"on {card}" + ("" if base == "bench" else
                            " (side by side with the other golden runs)")
            + "; counters equal to the golden")
    log(f"  oracle step (a): {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    hw = host.join()
    for name in ORACLE_RUNS:
        r = hw["oracle"][name]
        log(f"oracle {name} ({r['hosts']} hosts, {r['windows']} windows): "
            f"build {r['build_s']:.2f} s, run {r['run_s']:.2f} s "
            f"({r['events']} events) on {hw['cpu']}, in a process beside "
            f"the card phases; its {r['metrics']} metrics, every summary "
            f"and every digest word equal to the golden")
    cl = hw["cli_rung1"]
    want = [r for r in cuda["rung1"]["rows"]
            if r["type"] == "ring"][:ORACLE_CLI_WINDOWS]
    require([(r["window"], *(r[f] for f in DIGEST_FIELDS))
             for r in cl["rows"]]
            == [(r["window"], *(r[f] for f in DIGEST_FIELDS)) for r in want]
            and len(cl["rows"]) == ORACLE_CLI_WINDOWS,
            "--engine cpu on rung1: the digest rows differ from the CUDA "
            "run's ring rows")
    log(f"oracle --engine cpu rung1 ({ORACLE_CLI_WINDOWS} windows, in "
        f"process): {cl['wall_s']:.2f} s, digest rows equal to the CUDA "
        f"run's ring rows")
    tools = hw["tools"]
    log(f"pcapdump rung1: " + ", ".join(
        f"{c} {tools[f'pcap_{c}']} bytes" for c in PCAP_RUNS)
        + "; SHA-256 equal to the reference's")
    log(f"activeprobe tor10k: {tools['activeprobe']}; depthprobe tor10k: "
        f"{tools['depthprobe']}; equal to the reference's")
    log(f"  oracle step (b): host process joined {hw['since_start_s']:.1f} s "
        f"after its start (oracle {hw['oracle_s']:.1f} s, "
        + json.dumps({k: round(v, 1) for k, v in hw["step_s"].items()})
        + f"); {time.perf_counter() - t0:.1f} s wall here")
    t0 = time.perf_counter()
    card_tools = oracle_card_tools(dev, oracle_configs())
    for case, (cfg, _, _) in FLEETPROBE_RUNS.items():
        r = card_tools[f"fleetprobe_{case}"]
        log(f"fleetprobe {case} ({cfg}) on the card: {r['verdict']}, equal "
            f"to the reference's; launches {r['launches']}")
    log(f"occprobe dense_tgen50k (50,000 hosts, {' '.join(OCC_ARGS)}) on "
        f"the card: {card_tools['occprobe']['row']}, equal to the "
        f"reference's; launches {card_tools['occprobe']['launches']}")
    log(f"  oracle step (c): {time.perf_counter() - t0:.1f} s wall; "
        + json.dumps({k: round(v, 1)
                      for k, v in card_tools["step_s"].items()}))
    return dict(native=nat, host=hw, tools=card_tools, build_s=build_s,
                cpu=cpu)


# -- phase 19: the sharded engine ---------------------------------------------

SHARD_DIR = ROOT / "build" / "s19"
# configs/churn_filexfer.yaml as JSON (churnprobe on the card); its GraphML
# path is made absolute when the file is written (``shard_configs``).
CHURN_DOC = {
    "general": {"seed": 42, "stop_time": "6 s"},
    "engine": {"scheduler": "tpu", "ev_cap": 512},
    "network": {"graphml": "configs/topology_2pop.graphml"},
    "hosts": [{"name": "server", "count": 1, "vertex": "pop_west",
               "bandwidth_up": "20 Mbit", "bandwidth_down": "20 Mbit"},
              {"name": "client", "count": 7, "vertex": "pop_east",
               "bandwidth_up": "10 Mbit", "bandwidth_down": "10 Mbit"}],
    "app": {"model": "filexfer",
            "groups": {"server": {"role": 0},
                       "client": {"role": 1, "server": "@server",
                                  "flow_bytes": 250000, "flow_count": 12,
                                  "start_time": {"start": "10 ms",
                                                 "interval": "30 ms"}}}},
    "faults": {
        "hosts": [{"host": 2, "down_at": "800 ms", "up_at": "1.2 s"},
                  {"host": 2, "down_at": "2 s", "up_at": "2.4 s"},
                  {"host": 3, "down_at": "1.5 s", "up_at": "1.9 s"}],
        "links": [{"src_vertex": "pop_west", "dst_vertex": "pop_east",
                   "down_at": "3 s", "up_at": "3.25 s"}],
        "loss": [{"src_vertex": "pop_west", "dst_vertex": "pop_east",
                  "from": "3.5 s", "until": "4.5 s", "loss": 0.08}]},
}
# Step (c): paritytrace compares rung1's first PARITY_WINDOWS windows in
# chunks of PARITY_CHUNK, and its injection run INJECT_WINDOWS; churnprobe
# runs churn8's first CHURN_WINDOWS (its oracle side in a process of its
# own); the CLI runs rung1's first CLI_WINDOWS, sharded and solo;
# crossover two sizes of the dense tgen mesh over CROSSOVER_WINDOWS.
PARITY_WINDOWS, PARITY_CHUNK = 100, 50
INJECT_WINDOWS = 12
CHURN_WINDOWS, CHURN_CHUNK = 40, 20
CLI_WINDOWS = 100
CROSSOVER_HOSTS, CROSSOVER_WINDOWS = "2000,10000", 10
# Step (b): the reference's convergent case (every client of 32 → host 0,
# tests/test_shard_parity.py::test_x2x_auto_retry_convergent_traffic), at
# its 8 ranks of 4 hosts. At 2 ranks the auto cap, ceil(2·h_local·
# outbox_cap / D), is already the full cap h_local·outbox_cap, so no retry
# can fire there.
CONVERGENT_RANKS, CONVERGENT_WINDOWS = 8, 4
CONVERGENT_PARAMS = dict(ev_cap=64, outbox_cap=16, sockets_per_host=4)
# Metrics each rank counts for its own round loop, summed over the ranks
# (and the exchange's gauge, which a solo run does not have).
PER_SHARD = ("rounds", "round_cap_hits", "x2x_max_fill", "compact_max_fill",
             "fires_pkt", "fires_deliver", "fires_timer", "fires_txr",
             "fires_app")


def compute_mode() -> str:
    """The card's compute mode, as nvidia-smi reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else "unknown"


def shard_configs() -> dict:
    """Write the JSON mirrors phase 19's tools run; name → path."""
    SHARD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, doc in (("rung1", RUNG1_DOC), ("churn", CHURN_DOC)):
        doc = json.loads(json.dumps(doc))
        doc["network"]["graphml"] = str(ROOT / doc["network"]["graphml"])
        paths[name] = str(SHARD_DIR / f"{name}.json")
        Path(paths[name]).write_text(json.dumps(doc))
    return paths


def shard_golden() -> dict:
    return json.loads((ROOT / "shadow1_tpu_torch" / "golden"
                       / "shard2_filexfer16k.json").read_text())


def shard_world_of_one(dev) -> dict:
    """Step (a): tor10k at its full width (10,000 hosts, compact_cap
    1280, 40 windows) through a ShardedEngine in a world of one rank
    (NCCL, in this process), its launches and exchanges counted from 0,
    held to golden/net_tor10k.json in every metric (rounds included; the
    exchange's x2x_max_fill, which a solo run has not, is printed), the
    summary and the digest words; then the solo Engine on the same
    windows, for the ms per round beside it."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import compact
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.shard import engine as shard
    from shadow1_tpu_torch.shard.launch import init_world
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    gold = net_golden("tor10k")
    exp = net_experiment("tor10k", gold)
    windows = gold["windows"]
    params = EngineParams(**gold["params"], metrics_ring=windows,
                          state_digest=1)
    tmp = tempfile.mkdtemp(prefix="shadow1_s19_")
    init_world("nccl", 0, 1, os.path.join(tmp, "store"))
    try:
        eng = shard.ShardedEngine(exp, params, device=dev)
        sync(dev)
        zero_counts()
        for k in compact.WINDOWS:
            compact.WINDOWS[k] = 0
        shard.EXCHANGES["all_to_all"] = 0
        t0 = time.perf_counter()
        st = eng.run(eng.init_state(), n_windows=windows)
        sync(dev)
        wall = time.perf_counter() - t0
        launches, exchanges = read_counts(), shard.EXCHANGES["all_to_all"]
        cw = dict(compact.WINDOWS)
        m = Engine.metrics_dict(st)
        check_net_golden("tor10k", gold, eng, st, drain_ring(st, eng.window),
                         skip=("x2x_max_fill",))
        bucket = (eng._x2x_cap, eng._full_cap)
        st = eng = None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k in ("pop", "push", "obox") if launches[k] <= 0]
    require(not missing, f"sharded tor10k: kernels not launched: {missing}")
    require(exchanges == windows, f"sharded tor10k: {exchanges} exchanges "
            f"in {windows} windows")
    require(cw["compact"] > 0, f"sharded tor10k: no compacted window {cw}")
    solo = Engine(exp, params, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    st = solo.run(n_windows=windows)
    sync(dev)
    solo_wall = time.perf_counter() - t0
    require(Engine.metrics_dict(st)["rounds"] == m["rounds"],
            "sharded tor10k: one rank ran other rounds than the solo engine")
    return dict(wall_s=wall, rounds=m["rounds"], events=m["events"],
                windows=windows, hosts=exp.n_hosts, launches=launches,
                exchanges=exchanges, compact_windows=cw,
                x2x_max_fill=m["x2x_max_fill"], bucket=bucket,
                solo_wall_s=solo_wall)


def shard2_rank(rank, world) -> dict:
    """Step (b), one of the 2 gloo ranks on the card: filexfer16k's 20
    windows at 8,192 columns each, the launches counted from 0, held to
    golden/shard2_filexfer16k.json (the JAX ShardedEngine over 2 devices:
    every field) and to net_filexfer16k.json (every field but the
    per-shard ones). Rank 0 keeps the kernels' arguments of window
    NET_PATH_WINDOW (``NetPathCapture``) and holds each kernel to its
    plain version on them, timed (``check_path``)."""
    import contextlib

    import torch

    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import _build, popk
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.shard import engine as shard
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    _build.library()
    dev = torch.device("cuda", 0)
    gold, solo_gold = shard_golden(), net_golden("filexfer16k")
    exp = net_experiment("shard2_filexfer16k", gold)
    windows = gold["windows"]
    params = EngineParams(**gold["params"], metrics_ring=windows,
                          state_digest=1)
    eng = shard.ShardedEngine(exp, params, device=dev)
    sync(dev)
    zero_counts()
    shard.EXCHANGES["all_to_all"] = 0
    cap = NetPathCapture() if rank == 0 else contextlib.nullcontext()
    with cap:
        t0 = time.perf_counter()
        st = eng.init_state()
        init_push = popk.LAUNCHES["push"]
        st = eng.run(st, n_windows=windows)
        sync(dev)
        wall = time.perf_counter() - t0
    launches = read_counts()
    check_net_golden("shard2_filexfer16k", gold, eng, st,
                     drain_ring(st, eng.window))
    m = Engine.metrics_dict(st)
    diff = {k: (solo_gold["metrics"][k], v) for k, v in m.items()
            if k not in PER_SHARD and solo_gold["metrics"][k] != v}
    require(not diff, f"2 ranks: metrics differ from net_filexfer16k.json "
            f"(golden, port): {diff}")
    out = dict(wall_s=wall, rounds=m["rounds"], events=m["events"],
               windows=windows, hosts=exp.n_hosts, h_local=eng.h_local,
               launches=launches, init_push=init_push,
               rank_rounds=int(eng.local_metrics.rounds),
               exchanges=shard.EXCHANGES["all_to_all"],
               x2x_max_fill=m["x2x_max_fill"],
               bucket=(eng._x2x_cap, eng._full_cap))
    if rank == 0:
        st = eng = None
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        out["kernels"] = {name: check_path(name, cap.cases(name), dev, flush,
                                           expect=(1, 3))
                          for name in ("pop", "push", "obox")}
        out["actives"] = cap.actives()
    return out


def convergent_experiment():
    """The reference's convergent filexfer: 32 hosts, every client → host
    0, 10 ms paths with 1 % loss."""
    import numpy as np

    from shadow1_tpu_torch.config.compiled import single_vertex_experiment

    n = 32
    role = np.full(n, 1, np.int64)
    role[0] = 0
    return single_vertex_experiment(
        n_hosts=n, seed=42, end_time=1_000_000_000, latency_ns=10_000_000,
        loss=0.01, bw_bits=10**7, model="net",
        model_cfg={"app": "filexfer", "role": role,
                   "server": np.zeros(n, np.int64),
                   "flow_bytes": np.full(n, 30_000, np.int64),
                   "start_time": np.full(n, 1_000_000, np.int64),
                   "flow_count": np.where(role == 1, 1, 0)})


def convergent_rank(rank, world) -> dict:
    """Step (b), one of the 8 gloo ranks on the card: the auto cap
    overflows and ``run`` reruns at the full cap (a RuntimeWarning); the
    full cap set explicitly gives the same metrics; the auto cap set
    explicitly raises. Rank 0 also runs the solo engine."""
    import dataclasses
    import warnings

    import torch

    from shadow1_tpu_torch.consts import EngineParams
    from shadow1_tpu_torch.core import _build
    from shadow1_tpu_torch.core.engine import Engine
    from shadow1_tpu_torch.shard.engine import ShardedEngine

    _build.library()
    dev = torch.device("cuda", 0)
    exp, params = convergent_experiment(), EngineParams(**CONVERGENT_PARAMS)
    eng = ShardedEngine(exp, params, device=dev)
    cap0 = eng._x2x_cap
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        auto = Engine.metrics_dict(eng.run(n_windows=CONVERGENT_WINDOWS))
    full = Engine.metrics_dict(ShardedEngine(
        exp, dataclasses.replace(params, x2x_cap=eng._full_cap),
        device=dev).run(n_windows=CONVERGENT_WINDOWS))
    try:
        ShardedEngine(exp, dataclasses.replace(params, x2x_cap=cap0),
                      device=dev).run(n_windows=CONVERGENT_WINDOWS)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    out = dict(cap0=cap0, cap=eng._x2x_cap, full_cap=eng._full_cap,
               warned=any(issubclass(w.category, RuntimeWarning)
                          and "x2x" in str(w.message) for w in caught),
               auto=auto, full=full, raised=raised)
    if rank == 0:
        out["solo"] = Engine.metrics_dict(Engine(exp, params, device=dev).run(
            n_windows=CONVERGENT_WINDOWS))
    return out


def start_shard_tools(paths) -> list:
    """Step (c)'s subprocesses, started together: (name, process, stdout
    file, start)."""
    py = sys.executable
    tool = [py, "-m", "shadow1_tpu_torch.tools.{}"]
    cmds = {
        "paritytrace": [*tool[:2], tool[2].format("paritytrace"),
                        paths["rung1"], "tpu", "sharded:1", "--windows",
                        str(PARITY_WINDOWS), "--chunk", str(PARITY_CHUNK)],
        "paritytrace_inject": [*tool[:2], tool[2].format("paritytrace"),
                               paths["rung1"], "tpu", "sharded:1",
                               "--windows", str(INJECT_WINDOWS), "--chunk",
                               "10", "--inject", "5:rng"],
        "churnprobe": [*tool[:2], tool[2].format("churnprobe"),
                       paths["churn"], "--sides", "cpu,tpu,sharded:1",
                       "--windows", str(CHURN_WINDOWS), "--chunk",
                       str(CHURN_CHUNK)],
        "cli_sharded": [py, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "1", "-m", "shadow1_tpu_torch",
                        paths["rung1"], "--engine", "sharded", "--windows",
                        str(CLI_WINDOWS)],
        "cli_solo": [py, "-m", "shadow1_tpu_torch", paths["rung1"],
                     "--windows", str(CLI_WINDOWS)],
        "crossover": [*tool[:2], tool[2].format("crossover"), "--hosts",
                      CROSSOVER_HOSTS, "--windows", str(CROSSOVER_WINDOWS)],
    }
    out = []
    for name, cmd in cmds.items():
        path = SHARD_DIR / f"{name}.out"
        with open(path, "w") as fo, open(f"{path}.err", "w") as fe:
            out.append((name, subprocess.Popen(cmd, cwd=ROOT, stdout=fo,
                                               stderr=fe), path,
                        time.perf_counter()))
    return out


def finish_shard_tools(tools, timeout: float) -> dict:
    """Wait for ``start_shard_tools``' processes: name → (exit code, JSON
    lines of stdout, stderr, wall); a process past ``timeout`` is killed
    and fails the phase."""
    res, deadline = {}, time.perf_counter() + timeout
    try:
        for name, proc, path, t0 in tools:
            try:
                rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 19: {name} ran past {timeout} s")
            res[name] = (rc, [json.loads(s) for s in
                              Path(path).read_text().splitlines()
                              if s.startswith("{")],
                         Path(f"{path}.err").read_text(),
                         time.perf_counter() - t0)
    finally:
        for _, proc, _, _ in tools:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return res


def check_shard_tools(res: dict) -> dict:
    """Step (c)'s verdicts."""
    def ok(name, want=0):
        rc, lines, err, _ = res[name]
        require(rc == want and lines, f"phase 19: {name} exited {rc} "
                f"(expected {want}): {err[-2000:]}")
        return lines

    pt = ok("paritytrace")[-1]
    require(pt["first_divergence"] is None
            and pt["windows_compared"] == PARITY_WINDOWS,
            f"paritytrace tpu sharded:1: {pt}")
    inj = ok("paritytrace_inject", 3)[-1]
    require(inj["first_divergence"] == {"window": 5, "subsystems": ["rng"]},
            f"paritytrace --inject 5:rng named {inj['first_divergence']}")
    ch = ok("churnprobe")[-1]
    require(ch["ok"] and all(a["closes"] for a in ch["accounting"].values()),
            f"churnprobe: {ch}")
    sh, solo = ok("cli_sharded")[-1], ok("cli_solo")[-1]
    require(sh["engine"] == "sharded" and solo["engine"] == "tpu",
            f"the CLI's engines: {sh['engine']}, {solo['engine']}")
    diff = {k: (solo["metrics"][k], v) for k, v in sh["metrics"].items()
            if k != "x2x_max_fill" and solo["metrics"][k] != v}
    require(not diff and sh["summary"] == solo["summary"],
            f"torchrun --engine sharded differs from the solo CLI: {diff}")
    rows = ok("crossover")
    require(len(rows) == len(CROSSOVER_HOSTS.split(","))
            and all(r.get("events_per_sec") and r.get("cpp_events_per_sec")
                    and r.get("events_match") for r in rows),
            f"crossover rows: {rows}")
    return dict(paritytrace=pt, inject=inj, churnprobe=ch, cli=sh,
                crossover=rows,
                wall_s={k: v[3] for k, v in res.items()})


def phase_shard(dev, card: str) -> dict:
    """Phase 19, its steps' wall printed."""
    from shadow1_tpu_torch.shard.launch import RankGroup

    mode = compute_mode()
    log(f"sharded engine: the card's compute mode is {mode}")
    step_s = {}

    def step(name, t0):
        step_s[name] = time.perf_counter() - t0
        log(f"  shard step {name}: {step_s[name]:.1f} s wall")

    t0 = time.perf_counter()
    a = shard_world_of_one(dev)
    ms, solo_ms = (a["wall_s"] / a["rounds"] * 1e3,
                   a["solo_wall_s"] / a["rounds"] * 1e3)
    log(f"sharded tor10k, one rank, NCCL ({a['hosts']} hosts, compact_cap "
        f"1280): {a['events']} events, {a['rounds']} rounds, "
        f"{a['windows']} windows in {a['wall_s']:.3f} s = {ms:.2f} ms/round; "
        f"the solo engine {a['solo_wall_s']:.3f} s = {solo_ms:.2f} ms/round "
        f"in this call on {card} ({ms / solo_ms:.3f}x); every metric, "
        f"summary and digest word equal to net_tor10k.json; x2x_max_fill "
        f"{a['x2x_max_fill']} (bucket {a['bucket'][0]}, full "
        f"{a['bucket'][1]}); {a['exchanges']} all_to_all; launches "
        f"{a['launches']}; compaction windows {a['compact_windows']}")
    step("world of one", t0)

    t0 = time.perf_counter()
    # The tools need the card lightly: they run beside step (b).
    tools = start_shard_tools(shard_configs())
    b = None
    if mode == "Exclusive_Process":
        log("sharded engine: step (b) not run — the card is in "
            "Exclusive_Process mode, where two processes cannot share it")
    else:
        with RankGroup(2, "gloo", "cuda", deadline_s=600, threads=0) as g:
            b = g.call(shard2_rank)
        per = b["wall_s"] / b["rounds"] * 1e3
        log(f"sharded filexfer16k, 2 gloo ranks on the one card "
            f"({b['h_local']} columns each): {b['events']} events, "
            f"{b['rounds']} rounds (summed over the ranks), {b['windows']} "
            f"windows in {b['wall_s']:.3f} s = {per:.2f} ms per rank-round "
            f"on {card}; every field equal to shard2_filexfer16k.json (the "
            f"JAX ShardedEngine over 2 devices), every field but the "
            f"per-shard ones equal to net_filexfer16k.json; x2x_max_fill "
            f"{b['x2x_max_fill']} (bucket {b['bucket'][0]}); "
            f"{b['exchanges']} all_to_all; rank 0's launches {b['launches']} "
            f"({b['init_push']} pushes at init) over its own "
            f"{b['rank_rounds']} rounds")
        for name, r in b["kernels"].items():
            report_path(name, r, f"2-rank sharded path (filexfer16k window "
                        f"{NET_PATH_WINDOW}, h_local {b['h_local']})")
        step("2 ranks on one card", t0)
        t0 = time.perf_counter()
        with RankGroup(CONVERGENT_RANKS, "gloo", "cuda", deadline_s=600,
                       threads=0) as g:
            c = g.call(convergent_rank)
        require(c["cap"] == c["full_cap"] > c["cap0"] and c["warned"],
                f"convergent: the auto cap did not retry: {c}")
        require(c["auto"] == c["full"], "convergent: the retried run "
                "differs from the full-cap run")
        require(c["raised"] and "x2x_cap" in c["raised"],
                f"convergent: the explicit cap did not raise: {c['raised']}")
        diff = {k: (c["solo"][k], v) for k, v in c["auto"].items()
                if k not in PER_SHARD and c["solo"][k] != v}
        require(not diff, f"convergent: differs from the solo engine {diff}")
        log(f"convergent filexfer, {CONVERGENT_RANKS} gloo ranks on the one "
            f"card: the auto cap {c['cap0']} overflowed (demand "
            f"{c['auto']['x2x_max_fill']}) and run() reran at the full cap "
            f"{c['full_cap']} with a RuntimeWarning; equal to the full-cap "
            f"run and, but for the per-shard counters, to the solo engine; "
            f"an explicit cap of {c['cap0']} raised")
        b["convergent"] = c
        step("convergent retry", t0)
    t0 = time.perf_counter()
    tl = check_shard_tools(finish_shard_tools(tools, timeout=600))
    log(f"paritytrace rung1 tpu sharded:1: identical over "
        f"{PARITY_WINDOWS} windows; --inject 5:rng named (5, rng); "
        f"churnprobe churn8 cpu,tpu,sharded:1 ({CHURN_WINDOWS} windows): ok,"
        f" accounting closed; torchrun --nproc-per-node 1 --engine sharded "
        f"rung1: the solo CLI's result line; crossover "
        + "; ".join(f"{r['n_hosts']} hosts {r['events_per_sec']} events/s "
                    f"vs C++ {r['cpp_events_per_sec']}" for r in tl["crossover"])
        + "; walls " + json.dumps({k: round(v, 1)
                                   for k, v in tl["wall_s"].items()}))
    step("tools (joined)", t0)
    return dict(one=a, two=b, tools=tl, mode=mode, step_s=step_s)


# -- phase 20: perfprobe's shape ablations and benchgate's rows -------------

PERF_DIR = ROOT / "build" / "s20"
# filexfer16k's width: the FIFO planes of fx_mq64 are [64, 64, 16,384].
PERFPROBE_HOSTS = 16_384
BENCHGATE_GOLDEN = ROOT / "shadow1_tpu_torch" / "golden" / "benchgate_rows.json"
BENCHGATE_TIMEOUT_S = 600


def perf_probes(dev) -> dict:
    """Step (a): the four probes at ``PERFPROBE_HOSTS`` through
    ``perfprobe.probes`` and ``time_engine`` (warm 20, measure 40 windows),
    each with its launches counted from 0; fx_mq64's peak allocation beside
    its ``mem.estimate``."""
    from shadow1_tpu_torch import mem
    from shadow1_tpu_torch.tools import perfprobe

    rows = {}
    for name, exp, params in perfprobe.probes(PERFPROBE_HOSTS):
        est = mem.estimate(exp, params)
        base = clean_allocator(dev)
        zero_counts()
        t0 = time.perf_counter()
        r = perfprobe.time_engine(exp, params, device=dev)
        r["wall_s"] = time.perf_counter() - t0
        r["launches"] = read_counts()
        r["peak_bytes"] = measured_peak(dev, base)["allocated"]
        r["estimate_peak_bytes"] = est.peak_bytes
        r["estimate_resident_bytes"] = est.resident_bytes
        rows[name] = r
        missing = [k for k in ("pop", "push", "obox")
                   if r["launches"][k] <= 0]
        require(not missing, f"perfprobe {name}: kernels not launched: "
                f"{missing}")
        require(r["ev_overflow"] == r["ob_overflow"] == 0,
                f"perfprobe {name} overflowed: {r}")
    fx = [rows[n] for n in ("fx_s8", "fx_s64", "fx_mq64")]
    require(len({(r["events"], r["rounds_per_window"]) for r in fx}) == 1,
            "perfprobe: the filexfer probes differ in events or rounds per "
            "window, which only their shapes should separate: "
            + json.dumps({n: (rows[n]["events"], rows[n]["rounds_per_window"])
                          for n in ("fx_s8", "fx_s64", "fx_mq64")}))
    return rows


def start_benchgate():
    """Step (b)'s subprocess: ``benchgate --update`` into a temporary copy
    of the committed baseline, on the card, started beside step (a)."""
    import shutil

    from shadow1_tpu_torch.tools import benchgate

    PERF_DIR.mkdir(parents=True, exist_ok=True)
    tmp = PERF_DIR / "benchgate_baseline.json"
    shutil.copyfile(benchgate.BASELINE, tmp)
    out = PERF_DIR / "benchgate.out"
    with open(out, "w") as fo, open(f"{out}.err", "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "shadow1_tpu_torch.tools.benchgate",
             "--update", "--baseline", str(tmp)], cwd=ROOT, stdout=fo,
            stderr=fe)
    return proc, out


def finish_benchgate(proc, out: Path) -> dict:
    """Step (b)'s checks: the rows' deterministic fields held to the JAX
    package's (``benchgate_rows.json``), then each row gated against the
    committed ``cuda`` entry. The verdict is returned, never raised."""
    from shadow1_tpu_torch.tools import benchgate

    rc = proc.wait(timeout=BENCHGATE_TIMEOUT_S)
    lines = out.read_text().strip().splitlines()
    require(rc == 0 and len(lines) == 1,
            f"benchgate --update exited {rc}: {out.read_text()[-2000:]}"
            f"{Path(f'{out}.err').read_text()[-2000:]}")
    line = json.loads(lines[0])
    require(line["gate"] == "updated" and line["backend"] == "cuda",
            f"benchgate --update: {line}")
    golden = json.loads(BENCHGATE_GOLDEN.read_text())["rows"]
    rows = line["rows"]
    require(set(rows) == set(golden) == set(benchgate.ROWS),
            f"benchgate rows {sorted(rows)}, golden {sorted(golden)}")
    for name, want in golden.items():
        got = {k: rows[name].get(k) for k in want}
        require(got == want, f"benchgate {name}: {got} != the JAX "
                f"package's {want}")
    committed = json.loads(Path(benchgate.BASELINE).read_text())["rows"]
    verdicts = {name: benchgate.gate_row(
        name, row, committed.get(name, {}).get("cuda"), row["host"], None)
        for name, row in rows.items()}
    return {"rows": rows, "verdicts": verdicts}


def log_probes(a: dict, card: str) -> None:
    for name, r in a.items():
        log(f"perfprobe {name} ({PERFPROBE_HOSTS} hosts, warm 20 + measure "
            f"40 windows) on {card}: " + json.dumps(
                {k: r[k] for k in ("ms_per_window", "rounds_per_window",
                                   "ms_per_round", "events_per_sec", "events",
                                   "ev_overflow", "ob_overflow", "launches",
                                   "peak_bytes", "estimate_peak_bytes")})
            + f"; {r['wall_s']:.1f} s wall")
    s8, s64, mq64 = (a[n]["ms_per_round"] for n in ("fx_s8", "fx_s64",
                                                    "fx_mq64"))
    mq = a["fx_mq64"]
    log(f"perfprobe axes at {PERFPROBE_HOSTS} hosts on {card}: sockets "
        f"8 -> 64 {s64 - s8:+.3f} ms/round ({s8:.3f} -> {s64:.3f}); message "
        f"FIFO 8 -> 64 {mq64 - s64:+.3f} ms/round ({s64:.3f} -> "
        f"{mq64:.3f}); the phold floor {a['phold']['ms_per_round']:.3f} "
        f"ms/round; fx_mq64 peak allocated {mq['peak_bytes']:,} B against "
        f"mem.estimate's peak {mq['estimate_peak_bytes']:,} B "
        f"({mq['peak_bytes'] / mq['estimate_peak_bytes']:.3f}; resident "
        f"estimate {mq['estimate_resident_bytes']:,} B)")


def log_benchgate(b: dict, card: str) -> None:
    for name, v in b["verdicts"].items():
        log(f"benchgate {name} on {card}: {v['ms_per_round']} ms/round, "
            f"{v['rounds_per_chunk']} rounds in the best chunk, events "
            f"{v['events']} equal to the JAX package's; gate {v['gate']}"
            + (f" (baseline {v['baseline_ms_per_round']}, ratio "
               f"{v['ratio']}, tolerance {v['tolerance']})"
               if "ratio" in v else "")
            + f"; chunk walls {v['chunk_walls_s']}, compile wall "
            f"{v['compile_wall_s']} s; host {v['host']}")


def phase_perf(dev, card: str) -> dict:
    """Phase 20, its steps' wall printed. chip_smoke is not a perf gate:
    benchgate's timing verdicts (``failed`` included) are printed, and only
    an exception, a missing row or a count that differs from the JAX
    package's fails the phase."""
    step_s = {}

    def step(name, t0):
        step_s[name] = time.perf_counter() - t0
        log(f"  perf step {name}: {step_s[name]:.1f} s wall")

    t0 = time.perf_counter()
    proc, out = start_benchgate()
    try:
        a = perf_probes(dev)
        log_probes(a, card)
        step("perfprobe", t0)
        t0 = time.perf_counter()
        b = finish_benchgate(proc, out)
    finally:  # step (b)'s process never outlives the phase
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log_benchgate(b, card)
    step("benchgate (joined)", t0)
    return dict(probes=a, benchgate=b, step_s=step_s)

# -- phase 21: the performance-attribution plane ----------------------------

ATTR_DIR = ROOT / "build" / "s21"
ATTR_RUNG1 = "shadow1_tpu_torch/tools/benchgate_configs/rung1_filexfer.json"
# Step (a)'s self-test: ops added after every round of the rounds phase.
ATTR_INJECT = 60
# Step (c): phaseprobe's windows, warm-up and reps per config. rung1 runs
# ~33 rounds a window at a net round's 12-20 ms: 2 windows, not the
# default 16, keep the step inside the phase's budget.
PHASEPROBE_RUNS = {"smoke": dict(n_windows=16, warmup=8, reps=3),
                   ATTR_RUNG1: dict(n_windows=2, warmup=8, reps=3)}
PHASEPROBE_MIN_COVERAGE = 0.9
# The traced straight chunk of step (c): smoke windows 8-11.
PHASE_TRACE_WINDOWS = 4


def attr_census_cpu() -> dict:
    """Step (a)'s CPU census, in phase 18's host process: ``opcensus
    --device cpu`` on the default configs, gated against the committed
    ``cpu`` entry (rc and verdict returned, never raised)."""
    from shadow1_tpu_torch.tools import opcensus

    t0 = time.perf_counter()
    rc, lines = _tool_main(opcensus, ["--device", "cpu"])
    return {"rc": rc, "line": json.loads(lines[-1]),
            "wall_s": time.perf_counter() - t0}


def attr_fusion(dev) -> dict:
    """Step (b), run early (CUPTI drops records late in a process):
    ``opcensus``'s launch census (``--fusion``, ``count_fusions``) of
    rung1's window ``opcensus.WARMUP``: the kernels each window phase
    launched, read from ``torch.profiler`` captures, must equal the
    ``popk.LAUNCHES`` deltas of each phase for the three kernels (a phase
    is captured again, up to 3 times, when its capture falls short)."""
    from shadow1_tpu_torch.tools import opcensus
    from shadow1_tpu_torch.tools.phaseprobe import build_engine

    t0 = time.perf_counter()
    eng, label = build_engine(ATTR_RUNG1, device=dev)
    st = eng.run(eng.init_state(), n_windows=opcensus.WARMUP)
    eng.synchronize()
    warm_s = time.perf_counter() - t0
    f = opcensus.count_fusions(eng, st)
    require(f["complete"], f"opcensus --fusion {label}: the captures' "
            f"kernels {f['phases']} differ from popk.LAUNCHES "
            f"{f['launches']} (captures {f['attempts']})")
    rounds = f["launches"]["rounds"]
    require(all(rounds[k] > 0 for k in ("pop", "push", "obox")),
            f"opcensus --fusion {label}: kernels not launched in the rounds "
            f"phase: {rounds}")
    return dict(label=label, fusions=f, warm_s=warm_s,
                wall_s=time.perf_counter() - t0)


def attr_census(dev, fusion: dict) -> dict:
    """Step (a), run while the golden runs' processes work (its counts do
    not depend on the card's load): the CUDA census of the default
    configs, twice (equal key by key; rung1's launches per phase equal to
    step (b)'s); ``--inject`` trips the gate on ``rounds`` alone; the
    verdict against the committed ``cuda`` entry, printed, not fatal."""
    from shadow1_tpu_torch.tools import opcensus as oc

    def census(**kw):
        return dict(oc.run_census(cfg, device=dev, **kw)
                    for cfg in oc.DEFAULT_CONFIGS)

    t0 = time.perf_counter()
    a, b = census(), census()
    keys = ("ops", "reads", "launches", "window")
    for label in a:
        for k in keys:
            require(a[label][k] == b[label][k], f"opcensus {label}: {k} "
                    f"differs between two runs: {a[label][k]} vs "
                    f"{b[label][k]}")
        require(a[label]["launches"]["pop"] == {"pop": 1, "push": 0,
                                                "obox": 0},
                f"opcensus {label}: pop launched "
                f"{a[label]['launches']['pop']}")
    lab = oc.config_label(fusion["label"])
    want = {ph: n for ph, n in a[lab]["launches"].items()
            if ph in fusion["fusions"]["launches"]}
    require(fusion["fusions"]["launches"] == want,
            f"opcensus {lab}: the launch census's launches "
            f"{fusion['fusions']['launches']} differ from the census's {want}")
    hot = census(inject=ATTR_INJECT)
    fails = {label: oc.gate_config(hot[label], a[label], oc.TOLERANCE)
             for label in a}
    require(any(fails.values()) and all(
        "'rounds'" in f for fs in fails.values() for f in fs),
        f"opcensus --inject {ATTR_INJECT}: the gate's failures {fails}")
    for label in a:
        want = a[label]["ops"]["rounds"] + ATTR_INJECT * a[label]["window"][
            "rounds"]
        require(hot[label]["ops"]["rounds"] == want
                and {k: v for k, v in hot[label]["ops"].items()
                     if k != "rounds"}
                == {k: v for k, v in a[label]["ops"].items() if k != "rounds"}
                and hot[label]["reads"] == a[label]["reads"],
                f"opcensus --inject {ATTR_INJECT} {label}: {hot[label]['ops']}"
                f" against {a[label]['ops']}")
    committed = json.loads(Path(oc.BASELINE).read_text())
    verdicts = {}
    for label, c in a.items():
        entry = committed["configs"].get(label, {}).get("cuda")
        verdicts[label] = ("no_baseline_for_backend" if entry is None else
                           oc.gate_config(c, entry, committed["tolerance"])
                           or "ok")
    return dict(census=a, inject_fails=fails, verdicts=verdicts,
                wall_s=time.perf_counter() - t0)


def attr_census_against_cpu(a: dict, cpu: dict) -> None:
    """Step (a)'s last check: the host's CPU census (phase 18's process)
    has the card's reads and window."""
    for label, c in cpu["line"]["census"].items():
        require(c["reads"] == a["census"][label]["reads"]
                and c["window"] == a["census"][label]["window"],
                f"opcensus {label}: the CPU census's reads {c['reads']} or "
                f"window {c['window']} differ from the card's "
                f"{a['census'][label]['reads']} "
                f"{a['census'][label]['window']}")


def attr_phaseprobe(dev) -> dict:
    """Step (c): phaseprobe's attribution of smoke and rung1 (the staged
    run's metrics equal the straight run's: ``attribution`` asserts it),
    coverage at least ``PHASEPROBE_MIN_COVERAGE``; then one traced
    straight chunk of smoke (``--device-trace``): the four phase spans and
    the three kernels in its Chrome trace (taken again, up to 3 times,
    when CUPTI hands back no record of a kernel)."""
    from shadow1_tpu_torch.telemetry.profiler import TRACE_FILE, WINDOW_PHASES
    from shadow1_tpu_torch.tools import phaseprobe

    t0 = time.perf_counter()
    atts = {}
    for cfg, kw in PHASEPROBE_RUNS.items():
        eng, label = phaseprobe.build_engine(cfg, device=dev)
        att = phaseprobe.attribution(eng, **kw)
        require(att["coverage"] >= PHASEPROBE_MIN_COVERAGE,
                f"phaseprobe {label}: coverage {att['coverage']} below "
                f"{PHASEPROBE_MIN_COVERAGE}: {att}")
        atts[label] = {**att, "warmup": kw["warmup"]}
    eng, _ = phaseprobe.build_engine("smoke", device=dev)
    log_dir = ATTR_DIR / "trace"
    seen = []
    for _ in range(3):
        phaseprobe.device_trace_run(eng, str(log_dir), PHASE_TRACE_WINDOWS,
                                    PHASEPROBE_RUNS["smoke"]["warmup"])
        trace = json.loads((log_dir / TRACE_FILE).read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        lacking = [n for n in WINDOW_PHASES.values() if n not in names]
        require(not lacking, f"phaseprobe device trace lacks spans "
                f"{lacking}")
        got = trace_kernels(trace)
        seen.append(got)
        if all(got.get(k, 0) > 0 for k in ("pop", "push", "obox")):
            break
    else:
        raise AssertionError(f"phaseprobe device trace saw kernels {seen}")
    return dict(att=atts, trace_kernels=got, trace_attempts=len(seen),
                wall_s=time.perf_counter() - t0)


def attr_probes(dev) -> dict:
    """Step (d): roundprobe's probes and popprof's grid at their defaults;
    each kernel probe's final carry bit equal to the same loop through the
    plain versions."""
    from shadow1_tpu_torch.tools import popprof
    from shadow1_tpu_torch.tools import roundprobe as rp

    t0 = time.perf_counter()
    rows = {}
    for name in rp.PROBES:
        if name == "phold_win":
            rows[name] = rp.phold_win(device=dev)
            continue
        us, carry = rp.run_probe(name, device=dev)
        rows[name] = {"us_per_iter": us}
        if name in rp.KERNEL_PROBES:
            plain_us, ref = rp.run_probe(name, device=dev, plain=True)
            rows[name].update(plain_us_per_iter=plain_us,
                              bit_equal=rp.carries_equal(carry, ref))
            require(rows[name]["bit_equal"], f"roundprobe {name}: the "
                    f"kernel loop's carry differs from the plain loop's")
    pp = popprof.grid(device=dev)
    for r in pp:
        require(r["bit_equal"], f"popprof {r['probe']}: the kernel loop's "
                f"buffer differs from the plain loop's")
    return dict(roundprobe=rows, popprof=pp, wall_s=time.perf_counter() - t0)


def log_attr(fusion: dict, a: dict, cpu: dict, c: dict, d: dict,
             card: str) -> None:
    f = fusion["fusions"]
    log(f"opcensus --fusion {fusion['label']} (window 8) on {card}: device "
        f"records per phase " + json.dumps(f["phases"])
        + f", the three kernels equal to popk.LAUNCHES "
        f"{json.dumps(f['launches'])} (captures {json.dumps(f['attempts'])})"
        f"; {fusion['wall_s']:.1f} s (warm-up {fusion['warm_s']:.1f} s, "
        f"phases " + json.dumps({k: round(v, 1)
                                 for k, v in f["seconds"].items()})
        + ")")
    for label, cen in a["census"].items():
        log(f"opcensus {label} on {card} (window {cen['window']}): ops "
            + json.dumps(cen["ops"]) + "; reads " + json.dumps(cen["reads"])
            + "; kernel launches " + json.dumps(
                {p: n for p, n in cen["launches"].items() if any(n.values())})
            + f"; equal in two runs; verdict against the committed cuda "
            f"entry: {a['verdicts'][label]}")
    log(f"opcensus on the host's CPU (phase 18's process, "
        f"{cpu['wall_s']:.1f} s): gate {cpu['line']['gate']} (rc "
        f"{cpu['rc']}) against the committed cpu entry"
        + (f", fails {cpu['line'].get('fails')}" if cpu["rc"] else "")
        + "; reads and windows equal to the card's; ops "
        + json.dumps({k: v["ops"]["rounds"]
                      for k, v in cpu["line"]["census"].items()})
        + " in rounds")
    log(f"opcensus --inject {ATTR_INJECT}: fails "
        f"{json.dumps(a['inject_fails'])}"
        f"; {a['wall_s']:.1f} s for step (a), beside the golden runs")
    for label, att in c["att"].items():
        log(f"phaseprobe {label} on {card}: {att['windows']} windows after "
            f"{att['warmup']}, {att['rounds_per_window']} rounds/window, "
            f"{att['events']} "
            f"events, {att['ms_per_round']} ms/round straight; phases "
            + json.dumps({n: p["ms_per_round"]
                          for n, p in att["phases"].items()})
            + " ms/round; sub-phases " + json.dumps(
                {n: p["ms_per_round"] for n, p in att["subphases"].items()})
            + f"; coverage {att['coverage']}; staged equal to straight")
    log(f"phaseprobe --device-trace smoke ({PHASE_TRACE_WINDOWS} windows): "
        f"four phase spans, kernels {c['trace_kernels']} (trace "
        f"{c['trace_attempts']}); {c['wall_s']:.1f} s for step (c)")
    rp = d["roundprobe"]
    log(f"roundprobe (H 1,000, C 256, 5,000 iterations; phold_win 200 "
        f"windows) on {card}: " + json.dumps(
            {n: {k: (round(v, 1) if isinstance(v, float) else v)
                 for k, v in r.items() if k != "probe"}
             for n, r in rp.items()}) + "; every kernel probe bit equal to "
        "its plain loop")
    log(f"popprof (H 1,000, 5,000 iterations) on {card}: "
        + json.dumps(d["popprof"]) + f"; {d['wall_s']:.1f} s for step (d)")


def phase_attr(dev, card: str, fusion: dict, a: dict, host: dict) -> dict:
    """Phase 21: step (a)'s CPU comparison, then steps (c) and (d), one
    after the other, each step's wall printed (step (b) ran early:
    ``attr_fusion``; step (a)'s CUDA census beside the golden runs:
    ``attr_census``)."""
    step_s = {}

    def step(name, t0):
        step_s[name] = time.perf_counter() - t0
        log(f"  attribution step {name}: {step_s[name]:.1f} s wall")

    cpu = host["census_cpu"]
    attr_census_against_cpu(a, cpu)
    t0 = time.perf_counter()
    c = attr_phaseprobe(dev)
    step("(c) phaseprobe", t0)
    t0 = time.perf_counter()
    d = attr_probes(dev)
    step("(d) roundprobe and popprof", t0)
    log_attr(fusion, a, cpu, c, d, card)
    return dict(census=a, phaseprobe=c, probes=d, step_s=step_s)


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


def phase_fleet(dev, card: str) -> dict:
    """Phase 15, its four steps, each step's wall time printed."""
    import torch

    step_s = {}

    def step(name, t0):
        step_s[name] = time.perf_counter() - t0
        log(f"  fleet step {name}: {step_s[name]:.1f} s wall")

    t0 = time.perf_counter()
    sw = fleet_sweep(dev)
    log(f"fleet sweep_phold ({sw['lanes']} lanes x 64 hosts): "
        f"{sw['events']} events, {sw['rounds']} rounds (max over lanes) in "
        f"{sw['wall_s']:.3f} s; launches {sw['launches']}; the capped lane "
        f"hit its cap {sw['cap_hits']} times, pop's per-host bound (held "
        f"columns {sw['held']}) bit-equal to its plain version; every lane "
        f"equal to the JAX FleetEngine golden")
    step("sweep_phold", t0)

    t0 = time.perf_counter()
    fx = fleet_filexfer(dev)
    per_round = fx["wall_s"] / fx["rounds"] * 1e3
    log(f"fleet_filexfer16k ({fx['hosts']} host columns, 4 lanes): "
        f"{fx['events']} events, {fx['rounds']} rounds "
        f"({fx['rounds'] / fx['windows']:.2f} rounds/window, max over lanes)"
        f" in {fx['wall_s']:.3f} s = {per_round:.2f} ms/round, "
        f"{fx['events'] / fx['wall_s']:.0f} events/s aggregate on {card}; "
        f"the four solo runs {fx['solo_wall_s']:.3f} s summed; lane 0 equal "
        f"to net_filexfer16k.json windows 0-{FLEET_WINDOWS - 1}, every lane "
        f"equal to its solo run on the card")
    log(f"fleet_filexfer16k per round (window {FLEET_WINDOWS}, "
        f"{fx['extra_rounds']} rounds): {fx['ops_per_round']:.1f} device "
        f"ops (lane 0 solo, same window: {fx['solo_ops_per_round']:.1f}), "
        f"{fx['reads_per_round']:.2f} device->host reads ({fx['count_s']:.1f}"
        f" s in the counted windows); launches {fx['launches']} (push by "
        f"entry {fx['push_entries']})")
    log(f"fleet_filexfer16k memory: mem.estimate resident "
        f"{fx['estimated']} B vs {fx['resident']} B allocated after "
        f"init_state (ratio {fx['ratio']:.4f}); estimated peak "
        f"{fx['est_peak']} B, measured peak {fx['peak']['allocated']} B")
    step("filexfer16k x 4", t0)

    t0 = time.perf_counter()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    path = fleet_path(dev, flush)
    del flush
    log(f"fleet path: kept rounds of window {FLEET_PATH_WINDOW} with "
        f"{path['actives']} popping host columns")
    for name, r in path["kernels"].items():
        report_path(name, r, f"fleet path (fleet_filexfer16k window "
                    f"{FLEET_PATH_WINDOW}, H {fx['hosts']})")
    step("kernels in the fleet path", t0)

    t0 = time.perf_counter()
    rc = fleet_recovery(dev)
    log(f"fleet recovery on sweep_phold: retry from ev_cap "
        f"{FLEET_SMALL_CAP} ({rc['retry']['retries']} replays, to ev_cap "
        f"{rc['retry']['ev_cap']}); halt named lane {rc['halt']['lane']} "
        f"seed {rc['halt']['seed']}; quarantine of lane "
        f"{rc['quarantine']['exp']} at window {rc['quarantine']['window']}; "
        f"a window-{FLEET_SPLIT} snapshot ({rc['resume']['snap_bytes']} B) "
        f"resumed in a fresh FleetEngine and the capped lane sliced into a "
        f"solo Engine; every one equal to the golden")
    for k, v in rc["step_s"].items():
        log(f"    fleet recovery {k}: {v:.1f} s wall")
    step("recovery", t0)
    return dict(sweep=sw, filexfer=fx, path=path, recovery=rc,
                step_s=step_s)


def phase_serve(dev, card: str) -> dict:
    """Phase 16, its two steps, each step's wall time printed."""
    import torch

    step_s = {}

    def step(name, t0):
        step_s[name] = time.perf_counter() - t0
        log(f"  serve step {name}: {step_s[name]:.1f} s wall")

    t0 = time.perf_counter()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    sv = serve_tgen(dev, flush)
    del flush
    b1, b2, solo = sv["b1"], sv["b2"], sv["solo"]
    per_round = b1["wall_s"] / b1["rounds"] * 1e3
    solo_round = solo["wall_s"] / solo["rounds"] * 1e3
    log(f"served tgen50k (2 lanes, {sv['hosts']} host columns, "
        f"{SERVE_WINDOWS} windows) on {card}: batch wall {b1['wall_s']:.3f} "
        f"s ({b1['step_s']:.3f} s for the daemon's step, intake "
        f"{b1['intake_s']:.3f} s), {b1['rounds']} rounds = {per_round:.2f} "
        f"ms/round, {b1['events'] / b1['wall_s']:.0f} events/s aggregate; "
        f"solo seed 72 {solo['wall_s']:.3f} s, {solo['rounds']} rounds = "
        f"{solo_round:.2f} ms/round, {solo['events'] / solo['wall_s']:.0f} "
        f"events/s; seed 71 equal to net_tgen50k.json (experiment SHA-256 "
        f"and {SERVE_WINDOWS} windows of digest words), seed 72 equal to "
        f"its solo run on the card")
    log(f"served tgen50k launches over the batch: {sv['launches']} (push "
        f"by entry {sv['push_entries']}) = " + ", ".join(
            f"{k} {n / b1['rounds']:.2f}" for k, n in sv["launches"].items())
        + " per round")
    log(f"served tgen50k per round (window {SERVE_WINDOWS // 2}, "
        f"{sv['extra_rounds']} rounds): {sv['ops_per_round']:.1f} device "
        f"ops, {sv['reads_per_round']:.2f} device->host reads (counted in "
        f"the swapped batch, {sv['count_s']:.1f} s); solo seed 72 "
        f"on the same window: {solo['ops_per_round']:.1f} ops, "
        f"{solo['reads_per_round']:.2f} reads")
    log(f"served tgen50k swapped (seeds 72, 71): cache {b2['cache']}, the "
        f"same engine, no engine built; batch wall {b2['wall_s']:.3f} s "
        f"({b2['step_s']:.3f} s step, intake {b2['intake_s']:.3f} s); "
        f"engine build {sv['build_s']:.3f} s "
        f"(miss) vs rebind {sv['rebind_s']:.3f} s (hit); streams equal to "
        f"batch 1's")
    log(f"served tgen50k snapshots at batch end: {len(sv['saves'])} "
        f"(seconds {[round(x, 3) for x in sv['saves']]})")
    b0, b_in, b_1 = sv["budget"]
    log(f"served tgen50k idle budget (free + reserved): {b0} B before, "
        f"{b_in} B at the batch's boundaries, {b_1} B after")
    log(f"served tgen50k memory: mem.estimate resident "
        f"{sv['est_resident']} B vs {sv['resident']} B allocated after "
        f"init_state (ratio {sv['est_resident'] / sv['resident']:.4f}); "
        f"estimated peak {sv['est_peak']} B (the ctx tables aside), "
        f"measured peak of the swapped batch {sv['peak']['allocated']} B "
        f"over what was allocated before it (ratio "
        f"{sv['est_peak'] / sv['peak']['allocated']:.4f}); allocated "
        f"between the two batches: {sv['leftover']} B (the cached "
        f"engine's ctx tables, estimated: {sv['est_const']} B)")
    log(f"serve path: kept rounds of window {SERVE_PATH_WINDOW} with "
        f"{sv['actives']} popping host columns")
    for name, r in sv["kernels"].items():
        report_path(name, r, f"serve path (served tgen50k window "
                    f"{SERVE_PATH_WINDOW}, H {sv['hosts']})")
    step("tgen50k served", t0)

    t0 = time.perf_counter()
    pr = serve_probe()
    log(f"serveprobe (serve_phold, seeds 5 and 6) on {card}: every gate "
        f"passed in {pr['wall_s']:.1f} s — round trip "
        f"{pr['windows_compared']}, cache hits {pr['cache_hits']}, "
        f"over-budget rejected {pr['rejected_overbudget']}, shutdown rc "
        f"{pr['shutdown_rc']}; resilience {json.dumps({k: v for k, v in pr['resilience'].items() if k != 'ledger'})}; "
        f"preemption {json.dumps(pr['preemption'])}")
    step("serveprobe", t0)
    return dict(tgen=sv, probe=pr, step_s=step_s)


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
    # Phase 18's comparators build with g++ beside nvcc.
    native_builds = NativeBuild()
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
    # Phase 18's host-only work runs beside the card phases from here.
    import atexit

    oracle_host = OracleHostWork()
    atexit.register(oracle_host.kill)
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

    # Phase 14's step 1 runs here, while the profiler's traces are whole
    # (late in the process CUPTI can hand back no device record at all).
    t0 = time.perf_counter()
    ladder = recovery_kernels(g, dev)
    for c, rs in ladder.items():
        for name, r in rs.items():
            report_kernel(name, r, f"ladder cap C {c}")
    phase_done("kernels at ladder caps", t0)

    # Phase 21's step (b) runs here too: its trace must hold every launch.
    t0 = time.perf_counter()
    attr_fusion_run = attr_fusion(dev)
    phase_done("opcensus --fusion (phase 21 step (b))", t0)

    # Phase 15, the fleet, runs here too: its in-path kernel timings need
    # the profiler's traces whole.
    t0 = time.perf_counter()
    fleet = phase_fleet(dev, card)
    phase_done("fleet", t0)

    # Phase 16, the serve plane, right after: its in-path kernel timings
    # need the profiler's traces whole too.
    t0 = time.perf_counter()
    serve = phase_serve(dev, card)
    phase_done("serve", t0)

    # Phases 7, 9 and 11: the golden runs, side by side in processes of
    # their own; their checks and logs follow, phase by phase.
    t0 = time.perf_counter()
    golden_procs = GoldenWorkers()
    atexit.register(golden_procs.kill)
    # Phase 21's step (a) meanwhile: the census counts what is dispatched,
    # which the load of the card and the host does not change.
    attr_a = attr_census(dev, attr_fusion_run)
    golden = golden_procs.join()
    phase_done("golden runs of phases 7, 9 and 11, side by side", t0)

    t0 = time.perf_counter()
    net = golden["filexfer16k"]
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
    rung1 = golden["rung1"]
    log(f"net slice rung1 ({rung1['hosts']} hosts): {rung1['events']} "
        f"events, {rung1['rounds']} rounds, {rung1['windows']} windows in "
        f"{rung1['wall_s']:.3f} s ({rung1['wall_s'] / rung1['rounds'] * 1e3:.2f}"
        f" ms/round); equal to the JAX golden")
    phase_done("net slice", t0)

    t0 = time.perf_counter()
    with NetPathCapture() as ncap:
        run_net_golden("filexfer16k", dev, stop_after=NET_PATH_WINDOW + 2)
    log(f"net path: kept rounds of window {NET_PATH_WINDOW} with "
        f"{ncap.actives()} popping hosts")
    for name, r in net_checks.items():
        r.update(check_path(name, ncap.cases(name), dev, flush, expect=(1, 3)))
        report_path(name, r, f"net path (window {NET_PATH_WINDOW})")
    del ncap, flush
    phase_done("net path", t0)

    t0 = time.perf_counter()
    apps = {}
    for label, name, _ in golden_jobs():
        if name in APP_RUNS:
            r = apps[label] = golden[label]
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
        run_net_golden("tor10k", dev, stop_after=TOR_PATH_WINDOW + 2)
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
        r = fid[name] = golden[name]
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
        run_net_golden("fidelity16k", dev, stop_after=FID_PATH_WINDOW + 2)
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

    t0 = time.perf_counter()
    rec = phase_recovery(dev, card)
    phase_done("recovery planes", t0)

    t0 = time.perf_counter()
    tools = phase_tools(dev, card)
    phase_done("operator tools", t0)

    t0 = time.perf_counter()
    oracle = phase_oracle(dev, card, {
        "bench": bench, "filexfer16k": net, "tgen50k": apps["tgen50k"],
        "tor10k": apps["tor10k"], "bitcoin5k": fid["bitcoin5k"],
        "rung1": rung1}, native_builds, oracle_host)
    phase_done("oracle and comparator", t0)

    t0 = time.perf_counter()
    shard = phase_shard(dev, card)
    phase_done("sharded engine", t0)

    t0 = time.perf_counter()
    perf = phase_perf(dev, card)
    phase_done("perfprobe and benchgate", t0)

    t0 = time.perf_counter()
    attr = phase_attr(dev, card, attr_fusion_run, attr_a, oracle["host"])
    phase_done("performance attribution", t0)

    kernels = []
    for name, r in checks.items():
        n = net_checks[name]
        tk = tor_checks[name]
        err = max(r["max_abs_err"], r["path_err"], n["max_abs_err"],
                  n["path_err"], tk["max_abs_err"], tk["path_err"])
        if name == "push":
            err = max(err, back["path_err"])
        lad = {c: rs[name] for c, rs in ladder.items()}
        err = max(err, *(r["max_abs_err"] for r in lad.values()))
        fp = fleet["path"]["kernels"][name]
        err = max(err, fp["path_err"])
        sp = serve["tgen"]["kernels"][name]
        err = max(err, sp["path_err"])
        if name == "pop":
            err = max(err, fleet["sweep"]["until_err"])
        two = shard["two"]
        if two is not None:
            err = max(err, two["kernels"][name]["path_err"])
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
            "ladder_us": {c: r["ms"] * 1e3 for c, r in lad.items()},
            "ladder_bound_us": {c: r["bound_ms"] * 1e3
                                for c, r in lad.items()},
            "ladder_plain_us": {c: r["plain_ms"] * 1e3
                                for c, r in lad.items()},
            "recovery_launches": rec["retry"]["launches"][name],
            "recovery_launches_per_round": rec["retry"]["launches"][name]
            / rec["retry"]["rounds"],
            "fleet_launches": fleet["filexfer"]["launches"][name],
            "fleet_launches_per_round": fleet["filexfer"]["launches"][name]
            / fleet["filexfer"]["rounds"],
            "fleet_sweep_launches": fleet["sweep"]["launches"][name],
            "fleet_path_err": fp["path_err"],
            "fleet_path_us": fp["path_ms"] * 1e3,
            "fleet_path_bound_us": fp["path_bound_ms"] * 1e3,
            "fleet_path_plain_us": fp["path_plain_ms"] * 1e3,
            "fleet_path_wrapper_us": fp["path_wrapper_ms"] * 1e3,
            "fleet_path_case_us": [x * 1e3 for x in fp["path_case_ms"]],
            "fleet_path_active": fp["path_active"],
            "serve_launches": serve["tgen"]["launches"][name],
            "serve_launches_per_round": serve["tgen"]["launches"][name]
            / serve["tgen"]["b1"]["rounds"],
            "serve_path_err": sp["path_err"],
            "serve_path_us": sp["path_ms"] * 1e3,
            "serve_path_bound_us": sp["path_bound_ms"] * 1e3,
            "serve_path_plain_us": sp["path_plain_ms"] * 1e3,
            "serve_path_wrapper_us": sp["path_wrapper_ms"] * 1e3,
            "serve_path_case_us": [x * 1e3 for x in sp["path_case_ms"]],
            "serve_path_active": sp["path_active"],
            "perfprobe_launches": {
                k: p["launches"][name] for k, p in perf["probes"].items()},
            "opcensus_window_launches": {
                label: sum(c["launches"][ph][name] for ph in
                           ("prepare", "rounds", "deliver", "telem"))
                for label, c in attr["census"]["census"].items()},
            "roundprobe_us": attr["probes"]["roundprobe"][name][
                "us_per_iter"],
            "roundprobe_plain_us": attr["probes"]["roundprobe"][name][
                "plain_us_per_iter"],
            "shard_launches": shard["one"]["launches"][name],
            "shard_launches_per_round": shard["one"]["launches"][name]
            / shard["one"]["rounds"],
        })
        if two is not None:
            k2 = two["kernels"][name]
            kernels[-1].update({
                # Rank 0's launches over rank 0's own rounds, init_state's
                # pushes left out.
                "shard2_launches": two["launches"][name],
                "shard2_launches_per_round": (
                    two["launches"][name]
                    - (two["init_push"] if name == "push" else 0))
                / two["rank_rounds"],
                "shard2_path_err": k2["path_err"],
                "shard2_path_us": k2["path_ms"] * 1e3,
                "shard2_path_bound_us": k2["path_bound_ms"] * 1e3,
                "shard2_path_plain_us": k2["path_plain_ms"] * 1e3,
                "shard2_path_wrapper_us": k2["path_wrapper_ms"] * 1e3,
                "shard2_path_case_us": [x * 1e3 for x in k2["path_case_ms"]],
                "shard2_path_active": k2["path_active"],
            })
        if name == "pop":
            kernels[-1]["fleet_per_host_bound_err"] = \
                fleet["sweep"]["until_err"]
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

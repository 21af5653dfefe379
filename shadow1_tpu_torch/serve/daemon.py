"""The engine daemon — a persistent multi-tenant simulation service (port
of ``serve/daemon.py``).

``python -m shadow1_tpu_torch serve --spool DIR [--device cuda|cpu]
[--metrics-port P]`` starts a long-lived process that owns one spool
directory and serves job submissions (YAML or JSON experiment configs)
through four planes:

1. **hot engine cache** (serve/cache.py): built FleetEngines keyed by
   (shape class, caps, engine knobs, lane count, device); a repeat-shape
   batch rebinds its per-job variants into the cached engine instead of
   building one (hit/miss/evict counters on the ledger);
2. **two-tier admission with backpressure**: every submission is priced
   by the ``mem.estimate`` pre-flight (the state built on the meta
   device, or on the host when small) BEFORE any engine is built; only a job that could never fit an
   IDLE device is rejected (``error=memory_budget`` advice record). One
   that fits idle but not the live headroom is admitted as
   ``waiting_headroom`` and scheduled when the resident batch drains; the
   wait is bounded (--queue-depth / --queue-bytes) with a structured
   ``error=queue_full`` rejection carrying ``retry_after_s`` advice —
   never a silent drop, never an out-of-memory error for the tenants
   already running. --queue-ttl-s expires a job still waiting;
   --deadline-s bounds a running job at chunk boundaries, keeping its
   committed prefix (serve/client.py flags);
3. **lane-packing scheduler**: queued shape-compatible jobs bin into one
   fleet batch (lanes folded onto the host axis, fleet/run.py is the
   execution backend), always under ``on_lane_fail=quarantine`` (one
   tenant's capacity halt never kills cohabitants) and ``lane_finalize``
   (short jobs exit lanes early and free capacity); a higher-priority
   submission arriving mid-batch EVICTS the batch through the preemption
   plane — the drain latch commits the in-flight chunk, checkpoints the
   batch, and the preempted jobs requeue behind their checkpoint cursor,
   resuming bit-identically;
4. **per-job observability**: every ring/digest row is routed into the
   job's ``result.jsonl`` tagged with its job id, state transitions land
   as ``serve_job`` records (spool status files + serve.log), and the
   job ledger exports as Prometheus gauges (``--metrics-port``,
   SERVE_SPECS namespace).

The contract (docs/SEMANTICS.md §"Serving contract"): a job run through
the daemon produces a digest stream and parity counters bit-identical to
the same config run through the solo CLI — and to the JAX package's
solo run and daemon (``tests/test_torch_serve.py``). Lanes cannot
interact (fleet/engine.py) and the eviction path is the preemption
plane's commit-before-snapshot drain, so neither cohabitation nor
eviction can move a single bit of any tenant's stream.

Threads: the socket thread reads and writes spool files only. Admission
(pricing off the card), engine builds and every batch run on the
main loop's thread, the only one that touches the card.

Transient-failure retry (cli._supervise's classification, batch-scoped):
a batch that dies from anything but a deterministic taxonomy error
(allocator out-of-memory, capacity halt, memory budget, config,
selfcheck) is retried with exponential backoff
(SHADOW1_SERVE_RETRY_BACKOFF_S) from its last committed lineage
generation; the second crash of the same batch bisects the suspects into
solo batches, and --retry-max solo crashes make the job terminal
``failed`` with its crash ledger attached. A sticky CUDA fault (an
illegal address, a launch failure: the process's CUDA context is lost)
is not retried in process: the daemon persists its queue and exits
(:class:`DeviceLostError`, exit 1), leaving the batch's jobs non-terminal,
and a restart on the same spool requeues them from scratch.

Graceful shutdown: the first SIGTERM/SIGINT (or a socket ``shutdown``
op) reuses ``preempt.DrainHandler`` — the in-flight batch drains at its
next chunk boundary and checkpoints, queued jobs persist to
``queue.json`` (atomic), and the daemon exits ``EXIT_SERVE_SHUTDOWN``;
restarting on the same spool resumes exactly where it left off. A
SIGKILLed daemon loses only in-flight batch progress: on restart,
non-terminal jobs are re-validated and requeued from scratch —
determinism makes the re-run bit-identical. Spool ownership is an fcntl
flock plus a heartbeat/pid stale-lock protocol (serve/protocol.py) — a
SIGKILLed daemon's spool is reclaimed, even on NFS, while a live holder
is always refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import threading
import time

from shadow1_tpu_torch.consts import (
    EXIT_SERVE_SHUTDOWN,
    EXIT_SERVE_SPOOL,
)
from shadow1_tpu_torch.serve.protocol import (
    HEARTBEAT_S,
    J_DONE,
    J_EVICTED,
    J_FAILED,
    J_QUEUED,
    J_REJECTED,
    J_RUNNING,
    J_WAITING,
    TERMINAL_STATES,
    Spool,
    send_line,
)


class SpoolError(RuntimeError):
    """The spool directory cannot be owned (unusable, or a live daemon
    already holds it) — the daemon refuses to start (EXIT_SERVE_SPOOL)."""


class DeviceLostError(RuntimeError):
    """A batch died of a sticky CUDA fault: the process's CUDA context is
    lost, so no further batch can run in it. The daemon persists its queue
    and exits; the batch's jobs stay non-terminal, and a restart on the
    same spool requeues them from scratch (``ServeDaemon._recover``)."""


# CUDA errors that leave the process's context unusable (the CUDA runtime's
# own texts, as PyTorch and ``core/popk.py`` report them).
_STICKY_CUDA_TEXTS = (
    "illegal memory access", "unspecified launch failure",
    "misaligned address", "illegal instruction", "device-side assert",
    "uncorrectable ECC error", "launch timed out", "hardware stack error",
)


def is_sticky_cuda_error(e: BaseException) -> bool:
    """Does this exception carry a CUDA error that poisons the context?"""
    msg = str(e)
    return "CUDA" in msg and any(t in msg for t in _STICKY_CUDA_TEXTS)


def lane_params(params):
    """A job's EngineParams under the daemon's uniform lane policies:
    quarantine (one tenant's halt never kills cohabitants) + finalize
    (short jobs free their lane early). Ring transport for the digest
    stream mirrors the solo CLI's auto-provision. Admission prices the job
    at these params (``tools/serveprobe.py`` sizes its budgets so too)."""
    repl = {"on_lane_fail": "quarantine", "lane_finalize": 1}
    if params.state_digest and params.metrics_ring <= 0:
        repl["metrics_ring"] = 64
    return dataclasses.replace(params, **repl)


@dataclasses.dataclass
class ServeJob:
    """One admitted job: its compiled experiment plus scheduling state."""

    id: str
    exp: object                  # CompiledExperiment
    params: object               # EngineParams (daemon lane policies applied)
    priority: int
    seq: int                     # admission order (FIFO within priority)
    windows: int | None          # explicit horizon override, else config's
    est_peak: int                # pre-flight peak bytes (n_exp=1)
    queue_ttl_s: float | None = None   # expire if still waiting past this
    deadline_s: float | None = None    # bound on running wall time
    enqueued_at: float = 0.0     # wall time of admission (TTL + wait stats)
    first_run_at: float | None = None  # wall time of first batch_start
    waiting: bool = False        # admitted over live headroom (fits idle)
    solo: bool = False           # bisected after repeat crashes: own batch
    crashes: list = dataclasses.field(default_factory=list)  # crash ledger

    def pack_key(self):
        """Jobs with equal keys ride one fleet batch: same shape class,
        same engine params, same horizon (lanes run in lockstep)."""
        from shadow1_tpu_torch.serve.cache import shape_class_key

        return (shape_class_key(self.exp, self.params, 1)[0], self.params,
                self.windows)


class _EvictionLatch:
    """Duck-typed preempt.DrainHandler for the batch runner: ``requested``
    flips when the daemon must take the device back — a real signal, a
    socket shutdown op, or a higher-priority tenant waiting. Polled at
    chunk boundaries only (run_fleet's drain contract), and the poll IS
    the daemon's mid-batch admission step: new submissions are accepted /
    rejected while the batch runs, which is exactly how a higher-priority
    arrival becomes visible."""

    def __init__(self, daemon: "ServeDaemon", batch_priority: int):
        self.daemon = daemon
        self.batch_priority = batch_priority
        self.evicting = False
        self.deadline_jobs: list[str] = []
        self._polls = 0

    @property
    def requested(self) -> bool:
        d = self.daemon
        if (d._drain is not None and d._drain.requested) \
                or d._shutdown.is_set():
            return True
        # Chunk-boundary admission (main thread — no races). Exception-
        # isolated: one tenant's broken submission must never tear down
        # the batch the OTHER tenants are riding. The poll also refreshes
        # the spool heartbeat, sweeps queue TTLs and fires the chaos
        # crash-injection hook (a raise here surfaces as a transient
        # batch failure — the retry plane's test handle).
        self._polls += 1
        d._touch_heartbeat()
        d._safe_intake()
        d._expire_ttl()
        d._maybe_inject_crash(self._polls)
        if any(j.priority > self.batch_priority for j in d.queue):
            self.evicting = True
            return True
        over = d._running_over_deadline()
        if over:
            # --deadline-s enforcement is boundary-quantized by design:
            # the drain commits the in-flight chunk first, so the expired
            # job keeps its committed prefix (bit-identical to the same
            # prefix of a straight run) and its cohabitants resume from
            # the same snapshot, minus its lane.
            self.deadline_jobs = over
            return True
        return False

    @property
    def signame(self) -> str:
        if self.evicting:
            return "EVICT"
        if self.deadline_jobs:
            return "DEADLINE"
        if self.daemon._drain is not None and self.daemon._drain.requested:
            return self.daemon._drain.signame
        return "SHUTDOWN"


class _RecordRouter:
    """The batch's record streams, demultiplexed per job.

    Implements the file protocol run_fleet prints heartbeats/ring rows to
    (``write``/``flush``) plus the ``emit_record`` hook for immediately-
    final records. Ring/digest/work rows carry the lane id (``exp``) —
    each lands in its job's result.jsonl tagged with the job id, so a
    tenant's stream reads exactly like a solo run's stderr. Heartbeats
    and retry audits are fleet-level → the daemon log."""

    def __init__(self, daemon: "ServeDaemon", lane_jobs: dict[int, str],
                 batch_id: str):
        self.daemon = daemon
        self.lane_jobs = lane_jobs
        self.batch_id = batch_id
        self._buf = ""
        # One append handle per job for the batch's duration (a batch
        # streams O(windows x lanes) rows; per-row open/close would be
        # thousands of syscalls on the scheduler thread). Flushed per
        # line so a status transition written AFTER an append is never
        # visible before the record it follows.
        self._files: dict[str, object] = {}

    def _append(self, job: str, rec: dict) -> None:
        f = self._files.get(job)
        if f is None:
            os.makedirs(self.daemon.spool.job_dir(job), exist_ok=True)
            f = open(self.daemon.spool.result_path(job), "a")
            self._files[job] = f
        f.write(json.dumps(rec) + "\n")
        f.flush()

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()

    # -- file protocol (run_fleet's stream=) -------------------------------

    def write(self, s: str) -> None:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._line(line.strip())

    def flush(self) -> None:
        pass

    def _line(self, line: str) -> None:
        if not line.startswith("{"):
            return
        try:
            rec = json.loads(line)
        except ValueError:
            return
        t = rec.get("type")
        if t in ("ring", "ring_gap", "work", "digest",
                 "link", "link_gap", "flow", "flow_gap"):
            if t == "link":
                self.daemon._note_link(rec)
            job = self.lane_jobs.get(rec.get("exp"))
            if job is not None:
                self._append(job, {**rec, "job": job})
            return
        if t in ("fleet_quarantine", "fleet_exp"):
            return  # handled once, via the emit_record hook below
        self.daemon._log({**rec, "batch": self.batch_id}, echo=False)

    # -- emit_record hook (quarantine / early-finalize) --------------------

    def record(self, rec: dict) -> None:
        job = rec.get("job") or self.lane_jobs.get(rec.get("exp"))
        if job is None:
            return
        self._append(job, {**rec, "job": job})
        if rec.get("type") == "fleet_quarantine":
            self.daemon._job_failed(job, "capacity", rec)
        elif rec.get("type") == "fleet_exp":
            self.daemon._job_done(job, rec)


class ServeDaemon:
    """One spool's scheduler: intake → admission → lane-packed batches."""

    def __init__(self, spool_dir: str, metrics_port: int | None = None,
                 max_lanes: int = 8, cache_capacity: int = 4,
                 poll_s: float = 0.2, ckpt_every_s: float = 60.0,
                 log_level: str = "message", queue_depth: int = 64,
                 queue_bytes: int | None = None, retry_max: int = 3,
                 device=None):
        import torch

        from shadow1_tpu_torch.core.engine import resolve_device
        from shadow1_tpu_torch.log import SimLogger
        from shadow1_tpu_torch.serve.cache import EngineCache

        # CUDA unless the caller asks for another device; with no card this
        # raises (no silent CPU daemon). The index is pinned, so the cache
        # key names the card ("cuda:0").
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.spool = Spool(spool_dir)
        self.metrics_port = metrics_port
        self.max_lanes = max(int(max_lanes), 1)
        self.poll_s = poll_s
        self.ckpt_every_s = ckpt_every_s
        self.queue_depth = max(int(queue_depth), 1)
        self.queue_bytes = (int(queue_bytes)
                            if queue_bytes is not None else None)
        self.retry_max = max(int(retry_max), 1)
        self.cache = EngineCache(cache_capacity)
        self.log = SimLogger(level=log_level)
        self.queue: list[ServeJob] = []       # admitted, waiting
        self.resume: list[dict] = []          # evicted/retry-batch cursors
        self.jobs: dict[str, ServeJob] = {}   # every live ServeJob by id
        self.ledger = {k: 0 for k in
                       ("jobs_submitted", "jobs_rejected", "jobs_done",
                        "jobs_failed", "jobs_evicted", "batches_run",
                        "jobs_queue_full", "jobs_expired",
                        "batch_retries", "jobs_bisected",
                        "top_edge_bytes", "top_edge_drops")}
        self.running: list[str] = []          # job ids of in-flight batch
        self._resident_bytes = 0              # in-flight batch estimate
        self._drain = None                    # preempt.DrainHandler
        self._shutdown = threading.Event()    # socket shutdown op
        self._wake = threading.Event()        # socket submit nudge
        self._seq = 0
        self._batch_seq = 0
        self._sock_srv = None
        self._metrics_srv = None
        self._log_f = None
        self._lock_fd = None                  # held flock (spool ownership)
        self._hb_last = 0.0

    # -- events / ledger ---------------------------------------------------

    def _log(self, rec: dict, echo: bool = True) -> None:
        """One JSONL event into serve.log (the report tool's feed) and —
        for daemon-level events — onto stderr for live operators. One
        persistent append handle, flushed per line (heartbeats + job
        transitions would otherwise pay an open/close per record)."""
        line = json.dumps(rec)
        try:
            if self._log_f is None:
                self._log_f = open(self.spool.log_path, "a")
            self._log_f.write(line + "\n")
            self._log_f.flush()
        except OSError:
            pass
        if echo:
            print(line, file=sys.stderr, flush=True)

    def _event(self, event: str, **fields) -> None:
        self._log({"type": "serve", "event": event, "t": time.time(),
                   **fields})

    def _note_link(self, rec: dict) -> None:
        """Track the hottest / lossiest edge seen across every batch (link
        records are cumulative snapshots, so per-edge maxima are just the
        latest values) — exported as the top_edge_* Prometheus gauges."""
        b = int(rec.get("bytes", 0))
        d = (int(rec.get("loss_drops", 0))
             + int(rec.get("link_down_drops", 0))
             + int(rec.get("nic_backlog_drops", 0)))
        if b > self.ledger.get("top_edge_bytes", 0):
            self.ledger["top_edge_bytes"] = b
        if d > self.ledger.get("top_edge_drops", 0):
            self.ledger["top_edge_drops"] = d

    def ledger_dict(self) -> dict[str, int]:
        oldest = min((j.enqueued_at for j in self.queue
                      if j.enqueued_at), default=None)
        return {**self.ledger,
                "jobs_queued": len([j for j in self.queue
                                    if not j.waiting]),
                "jobs_waiting": len([j for j in self.queue if j.waiting]),
                "jobs_running": len(self.running),
                "queue_depth": len(self.queue),
                "queue_bytes": sum(j.est_peak for j in self.queue),
                "oldest_wait_s": (round(time.time() - oldest, 3)
                                  if oldest else 0),
                **self.cache.counters()}

    def _set_state(self, job_id: str, state: str, **fields) -> None:
        self.spool.write_status(job_id, {"state": state, **fields})
        self._log({"type": "serve_job", "job": job_id, "state": state,
                   "t": time.time(), **fields}, echo=False)

    # -- startup / teardown ------------------------------------------------

    def start(self) -> "ServeDaemon":
        try:
            self.spool.ensure()
            probe = os.path.join(self.spool.root, ".probe")
            with open(probe, "w") as f:
                f.write("rw")
            os.remove(probe)
        except OSError as e:
            raise SpoolError(
                f"spool {self.spool.root} is unusable: {e}") from e
        # Spool ownership, NFS-safe: the fcntl flock (kernel-released on
        # ANY death, including SIGKILL) is the same-host gate; the
        # heartbeat/pid protocol in holder_liveness covers holders the
        # flock can't see (another host on a network filesystem). A
        # stale holder — dead pid, or a cross-host heartbeat past the
        # stale threshold — is reclaimed; a live one is refused. Two
        # daemons can never interleave writes: on one host the flock
        # arbitrates, across hosts a live holder keeps its heartbeat
        # fresher than the reclaim threshold.
        self._lock_fd = self.spool.acquire_lock()
        if self._lock_fd is None:
            info = self.spool.daemon_info() or {}
            raise SpoolError(
                f"spool {self.spool.root} is owned by a live daemon "
                f"(flock held; pid {info.get('pid')}) — one daemon per "
                f"spool")
        liveness, info = self.spool.holder_liveness()
        try:
            holder_pid = int((info or {}).get("pid"))
        except (TypeError, ValueError):
            holder_pid = -1
        if liveness == "live" and holder_pid != os.getpid():
            try:
                os.close(self._lock_fd)
            finally:
                self._lock_fd = None
            raise SpoolError(
                f"spool {self.spool.root} is owned by a live daemon "
                f"(pid {info.get('pid')} on {info.get('host')}, "
                f"heartbeat fresh) — one daemon per spool")
        reclaimed = None
        if liveness == "stale":
            reclaimed = {"pid": (info or {}).get("pid"),
                         "host": (info or {}).get("host")}
            for p in (self.spool.daemon_path, self.spool.sock_path):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        self._start_socket()
        from shadow1_tpu_torch.lineage import write_json_atomic

        from shadow1_tpu_torch.serve.protocol import SPOOL_VERSION

        now = time.time()
        write_json_atomic(self.spool.daemon_path,
                          {"pid": os.getpid(),
                           "host": socket.gethostname(),
                           "started_at": now, "heartbeat_at": now,
                           "sock": self.spool.sock_path,
                           "spool_version": SPOOL_VERSION})
        self._hb_last = time.monotonic()
        if reclaimed:
            self._event("lock_reclaimed", stale_holder=reclaimed)
        if self.metrics_port is not None:
            from shadow1_tpu_torch.telemetry.registry import (
                SERVE_SPECS,
                ExpositionServer,
            )

            self._metrics_srv = ExpositionServer(
                self.ledger_dict, port=self.metrics_port,
                prefix="shadow1_serve", specs=SERVE_SPECS).start()
        self._recover()
        self._event("start", pid=os.getpid(), spool=self.spool.root,
                    metrics_port=(self._metrics_srv.port
                                  if self._metrics_srv else None))
        return self

    def _start_socket(self) -> None:
        try:
            os.unlink(self.spool.sock_path)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.spool.sock_path)
        srv.listen(16)
        self._sock_srv = srv

        def accept_loop():
            while True:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return  # server closed — daemon exiting
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()

        threading.Thread(target=accept_loop, daemon=True).start()

    def _serve_conn(self, conn) -> None:
        try:
            f = conn.makefile("rw", encoding="utf-8")
            line = f.readline()
            if not line:
                return
            try:
                req = json.loads(line)
            except ValueError:
                send_line(f, {"ok": False, "error": "bad json"})
                return
            op = req.get("op")
            if op == "ping":
                # A ping doubles as the scheduler nudge (client.submit
                # pings after writing its inbox file).
                self._wake.set()
                send_line(f, {"ok": True, "pid": os.getpid(),
                              "ledger": self.ledger_dict()})
            elif op == "submit":
                job = req.get("job") or {}
                if "config_yaml" not in job:
                    send_line(f, {"ok": False, "error": "no config_yaml"})
                    return
                job_id = self.spool.submit(job)
                self._wake.set()
                send_line(f, {"ok": True, "id": job_id})
            elif op == "status":
                st = self.spool.read_status(req.get("id", ""))
                send_line(f, st or {"ok": False, "error": "unknown job"})
            elif op == "watch":
                # Bounded: a status that never appears (bad id, job still
                # in the inbox) errors out after a short grace, and the
                # whole watch has a deadline — a disconnected client must
                # not pin a thread + fd for the daemon's lifetime.
                last = None
                grace = time.monotonic() + 30.0
                deadline = time.monotonic() + 3600.0
                while time.monotonic() < deadline:
                    st = self.spool.read_status(req.get("id", ""))
                    if st is None:
                        if time.monotonic() > grace:
                            send_line(f, {"ok": False,
                                          "error": "unknown job"})
                            return
                    elif st != last:
                        send_line(f, st)
                        last = st
                    if st is not None and st.get("state") in TERMINAL_STATES:
                        return
                    time.sleep(self.poll_s)
                send_line(f, {"ok": False, "error": "watch deadline"})
            elif op == "shutdown":
                self._shutdown.set()
                self._wake.set()
                send_line(f, {"ok": True})
            else:
                send_line(f, {"ok": False, "error": f"unknown op {op!r}"})
        except (OSError, BrokenPipeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        if self._sock_srv is not None:
            try:
                self._sock_srv.close()
            except OSError:
                pass
        if self._metrics_srv is not None:
            self._metrics_srv.stop()
        if self._log_f is not None:
            try:
                self._log_f.close()
            except OSError:
                pass
            self._log_f = None
        for p in (self.spool.sock_path, self.spool.daemon_path):
            try:
                os.unlink(p)
            except OSError:
                pass
        if self._lock_fd is not None:
            # Closing the fd releases the flock; the lock FILE stays
            # (unlinking a lock file races a concurrent opener).
            try:
                os.close(self._lock_fd)
            except OSError:
                pass
            self._lock_fd = None

    def _budget(self) -> tuple[int | None, str | None]:
        """The IDLE device's byte budget (``mem.device_budget``): on a card
        the free bytes plus this process's allocator reserve, so the
        daemon's own resident batch does not shrink it — admission rejects
        only what could never fit, and ``waiting_headroom`` subtracts the
        resident batch itself."""
        from shadow1_tpu_torch import mem

        return mem.device_budget(self.device)

    def _touch_heartbeat(self) -> None:
        """Refresh daemon.json's mtime (the stale-lock protocol's
        cross-host liveness signal), throttled to HEARTBEAT_S. Called
        from the run loop and at every chunk boundary, so a daemon deep
        in a long batch still reads as live."""
        now = time.monotonic()
        if now - self._hb_last < HEARTBEAT_S:
            return
        self._hb_last = now
        self.spool.touch_heartbeat()

    # -- recovery (restart on a used spool) --------------------------------

    def _recover(self) -> None:
        """Reload a persisted queue (graceful shutdown) and requeue any
        non-terminal jobs a SIGKILLed daemon left behind (from scratch —
        determinism makes the re-run bit-identical)."""
        cursors = []
        try:
            with open(self.spool.queue_path) as f:
                saved = json.load(f)
            os.remove(self.spool.queue_path)
        except (OSError, ValueError):
            saved = {}
        seen: set[str] = set()
        for cur in saved.get("resume", []):
            # A retry cursor's backoff stamp is monotonic time — it does
            # not survive the process; resume immediately instead.
            cur.pop("not_before", None)
            ok = True
            pending = []
            for j in cur.get("jobs", []):
                seen.add(j)
                st = self.spool.read_status(j)
                if st is not None and st.get("state") in TERMINAL_STATES:
                    continue  # finished before the eviction — stays done
                pending.append(j)
                # No short-circuit: every pending job must be readmitted
                # even after one fails, or the survivors would be
                # stranded in 'queued' with no ServeJob behind them.
                got = self._readmit(j)
                ok = ok and got
            if ok and pending and os.path.exists(cur.get("ckpt", "")):
                cursors.append(cur)
            else:
                # Checkpoint gone / a job no longer parses: the surviving
                # jobs rerun from scratch (bit-identical) instead.
                for j in pending:
                    if j in self.jobs and self._readmit(j, fresh=True):
                        self.queue.append(self.jobs[j])
        for job_id in saved.get("queued", []):
            if job_id not in seen and self._readmit(job_id):
                self.queue.append(self.jobs[job_id])
                seen.add(job_id)
        # Crash sweep: job dirs whose status never reached a terminal
        # state and which no cursor covers.
        try:
            leftover = sorted(os.listdir(self.spool.jobs))
        except OSError:
            leftover = []
        for job_id in leftover:
            if job_id in seen or not os.path.exists(
                    self.spool.job_path(job_id)):
                continue
            st = self.spool.read_status(job_id)
            if st is not None and st.get("state") in TERMINAL_STATES:
                continue
            if self._readmit(job_id, fresh=True):
                self.queue.append(self.jobs[job_id])
                self._event("requeue_after_crash", job=job_id)
        self.resume = cursors
        # Sweep stale batch checkpoints (a SIGKILLed incarnation's
        # lineage) and start the batch counter past every surviving name:
        # a fresh batch must never reuse a previous incarnation's
        # checkpoint path — a torn head there would make lineage resolve
        # fall back onto a DIFFERENT batch's snapshot.
        keep = {c.get("ckpt") for c in cursors}
        try:
            names = sorted(os.listdir(self.spool.batches))
        except OSError:
            names = []
        for name in names:
            path = os.path.join(self.spool.batches, name)
            base = name.split(".npz")[0] + ".npz"
            # Quarantined lanes' solo-resumable checkpoints
            # (<batch>.npz.q<exp>.npz) are tenant deliverables — their
            # failed statuses point at them; never swept.
            stale = (os.path.join(self.spool.batches, base) not in keep
                     and ".npz.q" not in name)
            if stale:
                try:
                    os.remove(path)
                except OSError:
                    pass
            if name.startswith("b") and name[1:7].isdigit():
                self._batch_seq = max(self._batch_seq,
                                      int(name[1:7]) + 1)
        if self.queue or self.resume:
            self._event("recovered", queued=len(self.queue),
                        resume_batches=len(self.resume))

    def _readmit(self, job_id: str, fresh: bool = False) -> bool:
        try:
            with open(self.spool.job_path(job_id)) as f:
                job = json.load(f)
        except (OSError, ValueError):
            return False
        sj = self._validate(job)
        if sj is None:
            return False
        sj.enqueued_at = time.time()
        self.jobs[job_id] = sj
        if fresh:
            # A from-scratch rerun must not append to a half-written
            # record stream from the killed attempt.
            try:
                os.remove(self.spool.result_path(job_id))
            except OSError:
                pass
        self._set_state(job_id, J_QUEUED, priority=sj.priority,
                        resumed=not fresh)
        return True

    # -- intake / admission ------------------------------------------------

    def _intake(self) -> int:
        """Accept/reject everything in the inbox. Runs on the main thread
        only — between batches and at chunk boundaries (the eviction
        latch), so admission never races the scheduler."""
        n = 0
        for path, job in self.spool.scan_inbox():
            if job is None:
                bad = path + ".bad"
                os.replace(path, bad)
                self._event("reject", reason="unparseable submission",
                            file=os.path.basename(bad))
                self.ledger["jobs_rejected"] += 1
                continue
            self.spool.accept(path, job)   # one atomic move — kill-safe
            self._admit(job)
            n += 1
        return n

    def _safe_intake(self) -> int:
        """Intake with per-call exception isolation — the form the
        eviction latch and the main loop use, so one broken submission
        (or a transient spool IO error) is logged, not fatal to the
        daemon or to an in-flight batch's tenants."""
        try:
            return self._intake()
        except Exception as e:  # noqa: BLE001 — isolation is the point
            self.log.warning("intake failed; will retry next boundary",
                             error=repr(e))
            return 0

    def _admit(self, job: dict) -> None:
        job_id = job["id"]
        self.ledger["jobs_submitted"] += 1
        sj = self._validate(job, reject_status=True)
        if sj is None:
            return
        # ---- two-tier admission (docs/SEMANTICS.md admission ordering):
        # (1) reject only what can NEVER fit — est_peak vs the IDLE
        # device budget, not the live headroom; (2) bounded queue with
        # backpressure — depth/bytes caps produce a structured
        # queue_full rejection with retry-after advice, never a silent
        # drop; (3) what fits idle but not the live headroom is admitted
        # as waiting_headroom and scheduled when resident bytes drain.
        from shadow1_tpu_torch import mem

        budget, budget_src = self._budget()
        if budget is not None and sj.est_peak > int(budget):
            est = mem.estimate(sj.exp, sj.params, fleet=([sj.exp], None))
            rec = est.record(budget, budget_src)
            err = {
                "error": "memory_budget",
                "estimated": est.peak_bytes,
                "budget": int(budget),
                "budget_source": budget_src,
                "resident": self._resident_bytes,
                "headroom": int(budget),
                "planes": rec["planes"],
                "peaks": rec["peaks"],
                "advice": est.advice(int(budget)),
            }
            self._reject(job_id, err)
            return
        q_depth = len(self.queue)
        q_bytes = sum(j.est_peak for j in self.queue)
        full_depth = q_depth >= self.queue_depth
        full_bytes = (self.queue_bytes is not None
                      and q_bytes + sj.est_peak > self.queue_bytes)
        if full_depth or full_bytes:
            # Advisory only, but never zero: at least one poll interval,
            # stretched by how long the current head has already waited
            # (a deep queue drains no faster than its oldest tenant).
            oldest = min((j.enqueued_at for j in self.queue
                          if j.enqueued_at), default=time.time())
            retry_after = round(max(2 * self.poll_s,
                                    0.5 * (time.time() - oldest)), 3)
            err = {
                "error": "queue_full",
                "cap": "depth" if full_depth else "bytes",
                "queue_depth": q_depth,
                "queue_depth_cap": self.queue_depth,
                "queue_bytes": q_bytes,
                "queue_bytes_cap": self.queue_bytes,
                "est_peak": sj.est_peak,
                "retry_after_s": retry_after,
            }
            self.ledger["jobs_queue_full"] += 1
            self._reject(job_id, err)
            self._queue_record("reject_full", job=job_id,
                               cap=err["cap"],
                               retry_after_s=retry_after)
            return
        sj.enqueued_at = time.time()
        sj.waiting = bool(budget is not None and self._resident_bytes > 0
                          and sj.est_peak > int(budget)
                          - self._resident_bytes)
        self.jobs[job_id] = sj
        self.queue.append(sj)
        self._set_state(job_id, J_WAITING if sj.waiting else J_QUEUED,
                        priority=sj.priority, est_peak=sj.est_peak)
        self._event("accept", job=job_id, priority=sj.priority,
                    hosts=sj.exp.n_hosts, est_peak=sj.est_peak,
                    waiting=sj.waiting)
        self._queue_record("waiting_headroom" if sj.waiting else "enqueue",
                           job=job_id)

    def _queue_record(self, event: str, **fields) -> None:
        """One serve_queue record (the backpressure plane's feed) with
        the queue's shape at this instant."""
        oldest = min((j.enqueued_at for j in self.queue
                      if j.enqueued_at), default=None)
        self._log({"type": "serve_queue", "event": event,
                   "depth": len(self.queue),
                   "bytes": sum(j.est_peak for j in self.queue),
                   "oldest_wait_s": (round(time.time() - oldest, 3)
                                     if oldest else 0.0),
                   "t": time.time(), **fields}, echo=False)

    def _reject(self, job_id: str, err: dict) -> None:
        self.ledger["jobs_rejected"] += 1
        self._set_state(job_id, J_REJECTED, error=err)
        self._event("reject", job=job_id,
                    reason=err.get("error", "config"))

    def _validate(self, job: dict, reject_status: bool = False
                  ) -> ServeJob | None:
        """Submission → ServeJob, or None after writing the rejection.
        Pure config work — no engine, no device allocation (the memory
        side builds the state on the meta device, or on the host when
        small)."""
        from shadow1_tpu_torch import mem
        from shadow1_tpu_torch.config.experiment import (
            build_experiment,
            parse_config,
        )

        job_id = job["id"]

        def bad(msg: str) -> None:
            if reject_status:
                self._reject(job_id, {"error": "config", "message": msg})

        try:
            doc = parse_config(job["config_yaml"])
        except ModuleNotFoundError:
            bad("config is not a JSON mapping and this machine has no YAML "
                "parser (pyyaml) — submit it as JSON")
            return None
        except Exception as e:  # noqa: BLE001 — yaml.YAMLError (yaml is
            # imported only for YAML text)
            bad(f"config does not parse as JSON or YAML: {e}")
            return None
        if not isinstance(doc, dict):
            bad("config must be a YAML or JSON mapping")
            return None
        if "sweep" in doc:
            bad("serve jobs are single experiments — submit each sweep "
                "variant as its own job (the scheduler packs compatible "
                "jobs into fleet lanes itself)")
            return None
        try:
            exp, params, scheduler = build_experiment(
                doc, base_dir=job.get("base_dir", "."))
        except Exception as e:  # noqa: BLE001 — any schema violation
            bad(f"config rejected: {e}")
            return None
        if scheduler != "tpu":
            bad(f"serve runs the batched tpu engine (lane-packed fleet); "
                f"engine.scheduler={scheduler!r} is not servable — drop "
                f"the override or run it through the solo CLI")
            return None
        params = lane_params(params)
        windows = job.get("windows")
        windows = int(windows) if windows is not None else None
        try:
            est_peak = mem.estimate(exp, params,
                                    fleet=([exp], None)).peak_bytes
        except Exception as e:  # noqa: BLE001 — estimator fails soft
            self.log.warning("memory estimate unavailable", job=job_id,
                             error=repr(e))
            est_peak = 0
        def _opt_s(key: str) -> float | None:
            v = job.get(key)
            try:
                return float(v) if v is not None else None
            except (TypeError, ValueError):
                return None

        self._seq += 1
        return ServeJob(id=job_id, exp=exp, params=params,
                        priority=int(job.get("priority", 0)),
                        seq=self._seq, windows=windows, est_peak=est_peak,
                        queue_ttl_s=_opt_s("queue_ttl_s"),
                        deadline_s=_opt_s("deadline_s"))

    # -- deadlines / retry plane -------------------------------------------

    def _expire_ttl(self) -> None:
        """Sweep --queue-ttl-s: a job still waiting for its FIRST batch
        past its TTL goes terminal with a structured deadline_expired
        record (jobs already run once — evicted or retried — are past
        the queue TTL's scope). Exception-isolated like intake: called
        from the main loop and from the eviction latch mid-batch."""
        try:
            now = time.time()
            for sj in list(self.queue):
                if sj.queue_ttl_s is None or sj.first_run_at is not None:
                    continue
                waited = now - sj.enqueued_at
                if waited <= sj.queue_ttl_s:
                    continue
                self.queue.remove(sj)
                self.ledger["jobs_expired"] += 1
                err = {"error": "deadline_expired", "kind": "queue_ttl",
                       "queue_ttl_s": sj.queue_ttl_s,
                       "waited_s": round(waited, 3)}
                self._log({"type": "serve_deadline", "job": sj.id,
                           "kind": "queue_ttl",
                           "waited_s": round(waited, 3),
                           "t": now}, echo=False)
                self.spool.append_result(sj.id, {
                    "type": "serve_deadline", "job": sj.id,
                    "kind": "queue_ttl", "waited_s": round(waited, 3)})
                self._job_failed(sj.id, "deadline_expired", err)
        except Exception as e:  # noqa: BLE001 — never tear down a batch
            self.log.warning("ttl sweep failed; will retry next boundary",
                             error=repr(e))

    def _running_over_deadline(self) -> list[str]:
        """Running jobs past their --deadline-s (measured from their
        first batch_start — requeues after eviction/retry don't reset
        the clock)."""
        now = time.time()
        out = []
        for job_id in self.running:
            sj = self.jobs.get(job_id)
            if (sj is not None and sj.deadline_s is not None
                    and sj.first_run_at is not None
                    and now - sj.first_run_at > sj.deadline_s):
                out.append(job_id)
        return out

    def _maybe_inject_crash(self, polls: int) -> None:
        """Chaos hook (tools/serveprobe.py): SHADOW1_SERVE_CRASH_BATCH
        names a countdown file; while its count is positive, the batch
        dies with a transient RuntimeError at its second chunk boundary
        (the first boundary has already committed a lineage generation
        when --ckpt-every-s permits, so the retry path resumes mid-run).
        Decrement-then-raise: each count buys exactly one crash."""
        path = os.environ.get("SHADOW1_SERVE_CRASH_BATCH")
        if not path or polls < 2:
            return
        try:
            with open(path) as f:
                n = int(f.read().strip() or 0)
        except (OSError, ValueError):
            return
        if n <= 0:
            return
        with open(path, "w") as f:
            f.write(str(n - 1))
        raise RuntimeError(
            "injected transient batch crash (SHADOW1_SERVE_CRASH_BATCH)")

    def _classify_failure(self, e: BaseException) -> str:
        """'sticky' | 'deterministic' | 'transient' — cli._supervise's
        rule, for batches. A sticky CUDA fault (``is_sticky_cuda_error``)
        has lost the process's CUDA context: nothing more runs in this
        process. PyTorch's allocator out-of-memory errors (``mem.is_oom``)
        and the structured taxonomy errors (capacity, memory budget,
        config, selfcheck) reproduce on retry by determinism, so retrying
        only re-kills the cohabitants; everything else (transport faults,
        injected chaos) is presumed transient."""
        from shadow1_tpu_torch import mem
        from shadow1_tpu_torch.fleet.expand import FleetConfigError
        from shadow1_tpu_torch.txn import CapacityExceededError, SelfCheckError

        if is_sticky_cuda_error(e):
            return "sticky"
        if mem.is_oom(e):
            return "deterministic"
        if isinstance(e, (CapacityExceededError, SelfCheckError,
                          FleetConfigError, mem.MemoryBudgetError)):
            return "deterministic"
        return "transient"

    def _retry_batch(self, e: BaseException, batch_id: str,
                     job_ids: list[str], ckpt: str,
                     prior_crashes: int) -> bool:
        """Absorb a transient batch failure: exponential-backoff retry
        from the last committed lineage generation; on the second crash
        of the same batch, bisect the suspects into solo batches (one
        poisonous tenant stops re-killing its cohabitants); a job that
        crashes its solo batch retry_max times goes terminal failed with
        its crash ledger attached. Returns True when the failure was
        absorbed here (retried, bisected, or terminalized)."""
        crashes = prior_crashes + 1
        err_s = f"{type(e).__name__}: {str(e)[:300]}"
        now = time.time()
        remaining = [j for j in job_ids
                     if j in self.jobs
                     and (self.spool.read_status(j) or {}).get("state")
                     not in TERMINAL_STATES]
        if not remaining:
            return False
        for j in remaining:
            self.jobs[j].crashes.append(
                {"t": now, "batch": batch_id, "attempt": crashes,
                 "error": err_s})
        base = float(os.environ.get("SHADOW1_SERVE_RETRY_BACKOFF_S",
                                    "0.5"))
        if len(remaining) == 1:
            sj = self.jobs[remaining[0]]
            if len(sj.crashes) >= self.retry_max:
                self._log({"type": "serve_retry", "event": "exhausted",
                           "batch": batch_id, "jobs": remaining,
                           "crashes": len(sj.crashes), "t": now},
                          echo=False)
                self._job_failed(sj.id, "retry_exhausted", {
                    "error": "retry_exhausted",
                    "crashes": sj.crashes, "message": err_s})
                self._finish_batch(batch_id, ckpt)
                return True
        elif crashes >= 2:
            # Bisect: every suspect reruns solo, from scratch (the fleet
            # snapshot can't be sliced without an engine — determinism
            # makes the from-scratch rerun bit-identical anyway).
            self.ledger["jobs_bisected"] += len(remaining)
            self._log({"type": "serve_retry", "event": "bisect",
                       "batch": batch_id, "jobs": remaining,
                       "attempt": crashes, "t": now}, echo=False)
            self._event("retry_bisect", batch=batch_id, jobs=remaining,
                        attempt=crashes)
            for j in remaining:
                sj = self.jobs[j]
                sj.solo = True
                try:
                    os.remove(self.spool.result_path(j))
                except OSError:
                    pass
                self.queue.append(sj)
                self._set_state(j, J_QUEUED, priority=sj.priority,
                                retrying=True, solo=True,
                                crashes=len(sj.crashes))
            self._finish_batch(batch_id, ckpt)
            return True
        backoff = round(base * (2 ** (crashes - 1)), 3)
        prio = max(self.jobs[j].priority for j in remaining)
        self.ledger["batch_retries"] += 1
        self.resume.append({"jobs": job_ids, "ckpt": ckpt,
                            "priority": prio, "crashes": crashes,
                            "retry": True,
                            "not_before": time.monotonic() + backoff})
        self._log({"type": "serve_retry", "event": "retry",
                   "batch": batch_id, "jobs": remaining,
                   "attempt": crashes, "backoff_s": backoff,
                   "error": err_s, "t": now}, echo=False)
        self._event("retry_backoff", batch=batch_id, jobs=remaining,
                    attempt=crashes, backoff_s=backoff, error=err_s)
        for j in remaining:
            self._set_state(j, J_QUEUED, priority=self.jobs[j].priority,
                            retrying=True, attempt=crashes,
                            backoff_s=backoff)
        self.running = []
        self._resident_bytes = 0
        self.ledger["batches_run"] += 1
        return True

    # -- scheduling --------------------------------------------------------

    def _pick_batch(self):
        """(jobs, cursor) — the next batch: an evicted batch resumes as
        soon as nothing strictly more important waits (jobs is then None;
        the cursor's lane↔job mapping is positional and resolved against
        the checkpoint manifest); otherwise the highest-priority queued
        job leads and every shape-compatible queued job packs in behind
        it (budget- and --max-lanes-capped)."""
        qprio = max((j.priority for j in self.queue), default=None)
        # Retry cursors in exponential backoff are invisible until their
        # not_before stamp passes — the queue keeps draining meanwhile.
        now = time.monotonic()
        ready = [c for c in self.resume
                 if c.get("not_before", 0) <= now]
        if ready:
            cur = max(ready, key=lambda c: (c["priority"],))
            if qprio is None or cur["priority"] >= qprio:
                self.resume.remove(cur)
                return None, cur
        if not self.queue:
            return None, None
        leader = sorted(self.queue, key=lambda j: (-j.priority, j.seq))[0]
        if leader.solo:
            # A bisected suspect rides alone — its crash must not take
            # cohabitants with it again.
            self.queue.remove(leader)
            return [leader], None
        key = leader.pack_key()
        cands = [j for j in sorted(self.queue, key=lambda j: j.seq)
                 if j.pack_key() == key and not j.solo]
        cap = self.max_lanes
        from shadow1_tpu_torch import mem

        budget, _ = self._budget()
        if budget is not None:
            # The most lanes of the leader's shape class whose estimated
            # peak fits the idle budget (the lanes share every shape).
            n = min(cap, len(cands))
            cap = min(cap, max(mem.max_lanes(
                leader.exp, leader.params, ([leader.exp] * n, None),
                int(budget)), 1))
        lanes = cands[:cap]
        if leader not in lanes:  # the cap sliced the leader out — keep it
            lanes = [leader] + lanes[:cap - 1]
        for j in lanes:
            self.queue.remove(j)
        return lanes, None

    def _run_next_batch(self) -> bool:
        from shadow1_tpu_torch import mem
        from shadow1_tpu_torch.fleet.run import final_records, run_fleet
        from shadow1_tpu_torch.lineage import Lineage
        from shadow1_tpu_torch.preempt import PreemptedExit
        from shadow1_tpu_torch.txn import CapacityExceededError

        lanes, cursor = self._pick_batch()
        if lanes is None and cursor is None:
            return False
        batch_id = f"b{self._batch_seq:06d}"
        self._batch_seq += 1
        # Crash count survives OUTSIDE the cursor: a batch whose retry
        # checkpoint is unusable falls back to a from-scratch rerun with
        # cursor=None, and forgetting its prior crashes there would retry
        # a poisonous batch forever instead of escalating to bisection.
        retry_crashes = int(cursor.get("crashes", 0)) if cursor else 0

        # ---- resume resolution (evicted-batch cursor) -------------------
        # The cursor's job list is POSITIONAL: index i is the lane id the
        # job had in the original batch, which is what the checkpoint
        # manifest's ``lanes`` meta (and every record's ``exp``) names.
        st = None
        resume_meta = None
        res_path = None
        caps_meta = None
        if cursor:
            job_ids = list(cursor["jobs"])
            ckpt = cursor["ckpt"]
            res = Lineage(ckpt).resolve(discard_invalid=True)
            live = None
            if res is not None and res.path is not None:
                meta = res.meta or {}
                live = [int(g) for g in
                        meta.get("lanes", range(len(job_ids)))]
                if all(job_ids[g] in self.jobs for g in live):
                    res_path = res.path
                    caps_meta = meta.get("caps")
                    resume_meta = {
                        "quarantined": meta.get("quarantined", []),
                        "finished": meta.get("finished", []),
                    }
            if res_path is None:
                # Checkpoint unusable (or a lane's job vanished): the
                # non-terminal jobs rerun from scratch — bit-identical by
                # determinism, so only wall time is lost.
                self._event("cursor_discarded", batch=batch_id, ckpt=ckpt)
                lanes = [self.jobs[j] for j in job_ids if j in self.jobs]
                if not lanes:
                    return True
                for j in lanes:
                    try:
                        os.remove(self.spool.result_path(j.id))
                    except OSError:
                        pass
                cursor = None
            else:
                lane_of = {g: self.jobs[job_ids[g]] for g in live}
        if not cursor:
            job_ids = [j.id for j in lanes]
            ckpt = os.path.join(self.spool.batches, batch_id + ".npz")
            live = list(range(len(lanes)))
            lane_of = dict(enumerate(lanes))
        params = lane_of[live[0]].params
        total = lane_of[live[0]].windows
        exps = [lane_of[i].exp for i in live]
        labels = [{"exp": i, "seed": int(lane_of[i].exp.seed),
                   "job": lane_of[i].id} for i in live]
        lane_jobs = {i: lane_of[i].id for i in live}

        if cursor and caps_meta:
            # Retry-grown caps from the evicted attempt, read off the
            # lineage manifest BEFORE the first cache lookup (the
            # solo-resume recipe): the hit/miss ledger then reflects the
            # engine that actually runs — never a hit followed by a
            # silent rebuild at the real caps.
            caps = (int(caps_meta.get("ev_cap", params.ev_cap)),
                    int(caps_meta.get("outbox_cap", params.outbox_cap)))
            if caps != (params.ev_cap, params.outbox_cap):
                params = dataclasses.replace(params, ev_cap=caps[0],
                                             outbox_cap=caps[1])
        # Engine build + resume load under the same batch isolation as
        # the run itself: one tenant's build-time OOM or a damaged
        # snapshot must fail THIS batch's jobs, never the whole daemon
        # (the other tenants' queue and the socket plane keep serving).
        try:
            engine, outcome = self.cache.get(exps, params,
                                             device=self.device)
            if cursor:
                from shadow1_tpu_torch.ckpt import (
                    load_fleet_state,
                    snapshot_caps,
                )
                from shadow1_tpu_torch.convert import fleet_to_saved

                template = engine.init_state()
                snap = snapshot_caps(fleet_to_saved(template, engine.n_exp),
                                     res_path)
                if snap and snap != (params.ev_cap, params.outbox_cap):
                    # Manifest-less fallback (legacy snapshot): rebuild
                    # at the snapshot's own caps.
                    params = dataclasses.replace(params, ev_cap=snap[0],
                                                 outbox_cap=snap[1])
                    engine, outcome = self.cache.get(exps, params,
                                                     device=self.device)
                    template = engine.init_state()
                st = load_fleet_state(template, res_path, engine.n_exp)
                del template
        except Exception as e:  # noqa: BLE001 — batch isolation
            if self._classify_failure(e) == "sticky":
                self._device_lost(batch_id, [lane_of[i].id for i in live], e)
            reason = "memory_exhausted" if mem.is_oom(e) else "runtime"
            for i in live:
                self._job_failed(lane_of[i].id, reason,
                                 {"error": reason,
                                  "message": str(e)[:500]})
            self._event("batch_failed", batch=batch_id,
                        reason=f"build:{reason}", error=str(e)[:400])
            self._finish_batch(batch_id, ckpt)
            self.log.warning("batch engine build failed", batch=batch_id,
                             error=repr(e))
            return True
        n_windows = total if total is not None else engine.n_windows
        remaining = n_windows
        if st is not None:
            done0 = int(st.win_start) // engine.window
            remaining = max(n_windows - done0, 0)

        self.running = [lane_of[i].id for i in live]
        self._resident_bytes = 0
        try:
            self._resident_bytes = mem.estimate(
                exps[0], params, fleet=(exps, None)).peak_bytes
        except Exception:  # noqa: BLE001 — estimator fails soft
            pass
        batch_priority = max(lane_of[i].priority for i in live)
        for i in live:
            if lane_of[i].first_run_at is None:
                lane_of[i].first_run_at = time.time()
            self._set_state(lane_of[i].id, J_RUNNING, batch=batch_id,
                            lane=i, lanes=len(live), cache=outcome,
                            resumed=bool(cursor))
        self._event("batch_start", batch=batch_id, jobs=self.running,
                    lanes=len(live), cache=outcome,
                    resumed=bool(cursor), windows=remaining,
                    priority=batch_priority)
        router = _RecordRouter(self, lane_jobs, batch_id)
        latch = _EvictionLatch(self, batch_priority=batch_priority)
        t0 = time.perf_counter()
        try:
            st, hb = run_fleet(
                engine, st, n_windows=remaining,
                every_windows=params.metrics_ring or None,
                stream=router,
                ckpt_path=ckpt, ckpt_every_s=self.ckpt_every_s,
                emit_heartbeat=True, emit_ring=True,
                selfcheck=bool(params.selfcheck),
                labels=labels, ckpt_keep=2, drain=latch,
                quarantine_base=ckpt,
                emit_record=router.record,
                resume_meta={"jobs": job_ids},
                recovery_seed=resume_meta,
                # A finished batch's lineage is deleted at once
                # (_finish_batch): its last snapshot would be host work
                # that nothing reads (PERF.md §6: 23.4-23.6 s for two
                # lanes of tgen50k).
                final_snapshot=False,
            )
            hb.engine.synchronize()
        except PreemptedExit as e:
            self._preempted_batch(batch_id, latch, job_ids, ckpt,
                                  st=e.st)
            router.close()
            return True
        except CapacityExceededError as e:
            # Every lane quarantined: each already got its record + its
            # failed status through the router; nothing left to mark.
            self._event("batch_failed", batch=batch_id,
                        reason="capacity", error=str(e)[:400])
            self._finish_batch(batch_id, ckpt)
            router.close()
            return True
        except Exception as e:  # noqa: BLE001 — one batch must not kill the daemon
            router.close()
            kind = self._classify_failure(e)
            if kind == "sticky":
                self._device_lost(batch_id, list(self.running), e)
            if kind == "transient":
                # cli._supervise's classification, batch-scoped: presumed
                # device/transport flake — retry with backoff from the
                # last committed generation instead of failing tenants.
                if self._retry_batch(e, batch_id, job_ids, ckpt,
                                     retry_crashes):
                    self.log.warning("transient batch failure; retrying",
                                     batch=batch_id, error=repr(e))
                    return True
            reason = "memory_exhausted" if mem.is_oom(e) else "runtime"
            for job_id in list(self.running):
                self._job_failed(job_id, reason,
                                 {"error": reason,
                                  "message": str(e)[:500]})
            self._event("batch_failed", batch=batch_id, reason=reason,
                        error=str(e)[:400])
            self._finish_batch(batch_id, ckpt)
            if reason == "runtime":
                self.log.warning("batch runtime failure", batch=batch_id,
                                 error=repr(e))
            return True
        wall = time.perf_counter() - t0
        recs, summary = final_records(hb.engine, st, hb.labels, n_windows,
                                      wall, resumed=bool(cursor),
                                      recovery=hb.recovery)
        for rec in recs:
            router.record(rec)
        self._log({**summary, "batch": batch_id}, echo=False)
        self._event("batch_done", batch=batch_id, wall_s=round(wall, 3),
                    lanes=len(hb.labels),
                    quarantined=len(hb.recovery["quarantined"]),
                    finished_early=len(hb.recovery["finished"]))
        self._finish_batch(batch_id, ckpt)
        router.close()
        return True

    def _device_lost(self, batch_id: str, job_ids: list[str],
                     e: BaseException) -> None:
        """A sticky CUDA fault: the context is gone, so no retry in this
        process can succeed. Persist the queue and raise DeviceLostError;
        the batch's jobs stay non-terminal, so a restart on the same spool
        requeues them from scratch (``_recover``'s crash sweep) — the
        re-run is bit-identical by determinism."""
        self._event("device_lost", batch=batch_id, jobs=job_ids,
                    error=f"{type(e).__name__}: {str(e)[:400]}")
        self._persist_queue()
        raise DeviceLostError(
            f"batch {batch_id} hit a sticky CUDA fault; the daemon exits "
            f"and a restart requeues jobs {job_ids}: {e}") from e

    def _preempted_batch(self, batch_id: str, latch, job_ids: list[str],
                         ckpt: str, st=None) -> None:
        """The drain latch fired mid-batch: the chunk committed and the
        batch checkpointed (run_fleet's drain contract). Jobs still in
        the fleet requeue behind the checkpoint cursor — an eviction's
        tenants resume bit-identically once the device frees up; a
        shutdown's tenants resume on the next daemon start. A DEADLINE
        drain first terminalizes the expired jobs (their result streams
        keep the committed prefix) and slices their lanes out of the
        committed snapshot, so cohabitants resume undisturbed."""
        expired = [j for j in getattr(latch, "deadline_jobs", [])
                   if j in job_ids
                   and (self.spool.read_status(j) or {}).get("state")
                   not in TERMINAL_STATES]
        for job_id in expired:
            sj = self.jobs.get(job_id)
            ran = (round(time.time() - sj.first_run_at, 3)
                   if sj is not None and sj.first_run_at else None)
            err = {"error": "deadline_expired", "kind": "running",
                   "deadline_s": getattr(sj, "deadline_s", None),
                   "ran_s": ran}
            self.ledger["jobs_expired"] += 1
            self._log({"type": "serve_deadline", "job": job_id,
                       "kind": "running", "batch": batch_id,
                       "ran_s": ran, "t": time.time()}, echo=False)
            self.spool.append_result(job_id, {
                "type": "serve_deadline", "job": job_id,
                "kind": "running", "batch": batch_id, "ran_s": ran})
            self._job_failed(job_id, "deadline_expired", err)
        if expired and st is not None:
            self._drop_expired_lanes(ckpt, job_ids, set(expired), st)
        remaining = [j for j in job_ids
                     if (self.spool.read_status(j) or {}).get("state")
                     not in TERMINAL_STATES]
        evicting = latch.evicting
        if remaining:
            prio = max((self.jobs[j].priority for j in remaining
                        if j in self.jobs), default=0)
            cursor = {"jobs": job_ids, "ckpt": ckpt, "priority": prio}
            self.resume.append(cursor)
            for job_id in remaining:
                if evicting:
                    self.ledger["jobs_evicted"] += 1
                    self._set_state(job_id, J_EVICTED, batch=batch_id,
                                    ckpt=ckpt)
                    self.spool.append_result(job_id, {
                        "type": "serve", "event": "evict", "job": job_id,
                        "batch": batch_id, "ckpt": ckpt})
                self._set_state(job_id, J_QUEUED, resumed=True,
                                priority=(self.jobs[job_id].priority
                                          if job_id in self.jobs else 0))
        self._event("evict" if evicting else "batch_drained",
                    batch=batch_id, jobs=remaining, ckpt=ckpt,
                    signal=latch.signame, expired=expired)
        self.running = []
        self._resident_bytes = 0
        self.ledger["batches_run"] += 1
        if not remaining:
            # Every tenant is terminal (e.g. the whole batch expired):
            # nothing resumes, so the checkpoint lineage is garbage now.
            from shadow1_tpu_torch.lineage import Lineage

            Lineage(ckpt).remove_all()
            for suffix in (".progress", ".meta"):
                try:
                    os.remove(ckpt + suffix)
                except OSError:
                    pass

    def _drop_expired_lanes(self, ckpt: str, job_ids: list[str],
                            expired: set, st) -> None:
        """Re-save the drain's committed snapshot minus the expired
        jobs' lanes (run_fleet's _repack recipe: lanes cannot interact,
        so select_lanes preserves every surviving lane's continuation
        bit-exactly). The sliced generation is what
        the resume cursor resolves, so the survivors' batch rebuilds at
        the smaller lane count without ever touching the expired lanes.
        Fails soft: without the slice, resume falls back to the
        cursor_discarded from-scratch rerun — slower, still correct."""
        try:
            from shadow1_tpu_torch.convert import fleet_to_saved
            from shadow1_tpu_torch.fleet.engine import select_lanes
            from shadow1_tpu_torch.lineage import Lineage

            lin = Lineage(ckpt)
            res = lin.resolve(discard_invalid=True)
            if res is None or res.path is None:
                return
            meta = dict(res.meta or {})
            lanes = [int(g) for g in
                     meta.get("lanes", range(len(job_ids)))]
            keep = [i for i, g in enumerate(lanes)
                    if job_ids[g] not in expired]
            if not keep or len(keep) == len(lanes):
                return
            meta["lanes"] = [lanes[i] for i in keep]
            lin.save(fleet_to_saved(select_lanes(st, keep, len(lanes)),
                                    len(keep)), meta)
        except Exception as e:  # noqa: BLE001 — fall back to from-scratch
            self.log.warning("expired-lane slice failed; survivors will "
                             "rerun from scratch", error=repr(e))

    def _finish_batch(self, batch_id: str, ckpt: str) -> None:
        from shadow1_tpu_torch.lineage import Lineage

        Lineage(ckpt).remove_all()
        for suffix in (".progress", ".meta"):
            try:
                os.remove(ckpt + suffix)
            except OSError:
                pass
        self.running = []
        self._resident_bytes = 0
        self.ledger["batches_run"] += 1

    def _job_done(self, job_id: str, rec: dict) -> None:
        self.ledger["jobs_done"] += 1
        self.jobs.pop(job_id, None)
        prev = self.spool.read_status(job_id) or {}
        self._set_state(job_id, J_DONE,
                        windows=rec.get("windows"),
                        events=(rec.get("metrics") or {}).get("events"),
                        finished_early=bool(rec.get("finished_early")),
                        cache=prev.get("cache"), lane=prev.get("lane"),
                        lanes=prev.get("lanes"), batch=prev.get("batch"))
        if job_id in self.running:
            self.running.remove(job_id)

    def _job_failed(self, job_id: str, reason: str, rec: dict) -> None:
        self.ledger["jobs_failed"] += 1
        self.jobs.pop(job_id, None)
        self._set_state(job_id, J_FAILED, reason=reason, error=rec)
        if job_id in self.running:
            self.running.remove(job_id)

    # -- main loop ---------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration; returns True when work was done
        (tests drive the daemon through this without threads)."""
        self._safe_intake()
        self._expire_ttl()
        self._touch_heartbeat()
        if self._draining():
            return False
        if self.resume or self.queue:
            # May still be idle: every cursor can sit in retry backoff.
            return self._run_next_batch()
        return False

    def _draining(self) -> bool:
        return (self._drain is not None and self._drain.requested) \
            or self._shutdown.is_set()

    def run(self) -> int:
        from shadow1_tpu_torch.preempt import DrainHandler

        self._drain = DrainHandler().install()
        try:
            while True:
                worked = self.step()
                if self._draining():
                    break
                if not worked:
                    self._wake.wait(self.poll_s)
                    self._wake.clear()
        finally:
            self._persist_queue()
            self._event("shutdown", queued=len(self.queue),
                        resume_batches=len(self.resume),
                        ledger=self.ledger_dict())
            self.close()
        return EXIT_SERVE_SHUTDOWN

    def _persist_queue(self) -> None:
        from shadow1_tpu_torch.lineage import write_json_atomic

        write_json_atomic(self.spool.queue_path, {
            "queued": [j.id for j in
                       sorted(self.queue, key=lambda j: j.seq)],
            "resume": self.resume,
            "persisted_at": time.time(),
        })


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m shadow1_tpu_torch serve",
        description="persistent multi-tenant engine daemon "
                    "(shadow1_tpu_torch/serve/)")
    ap.add_argument("--spool", required=True, metavar="DIR",
                    help="spool directory (job inbox, per-job results, "
                         "queue state, Unix socket)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be "
                         "present; 'cpu' runs the kernels' plain PyTorch "
                         "versions)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="serve the job-ledger gauges as Prometheus text "
                         "on 127.0.0.1:P (0 = ephemeral port, printed in "
                         "the start event)")
    ap.add_argument("--max-lanes", type=int, default=8,
                    help="max shape-compatible jobs packed into one "
                         "fleet batch (the budget may cap it lower)")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="admission backpressure: max jobs waiting "
                         "(queued + waiting_headroom); beyond it, "
                         "submissions get a structured queue_full "
                         "rejection with retry_after_s advice")
    ap.add_argument("--queue-bytes", type=int, default=None,
                    metavar="BYTES",
                    help="admission backpressure: cap on the summed "
                         "est_peak bytes of waiting jobs (default "
                         "unbounded)")
    ap.add_argument("--retry-max", type=int, default=3,
                    help="terminal-failure threshold: a job whose "
                         "batches crash transiently this many times "
                         "(solo included) fails with its crash ledger")
    ap.add_argument("--cache-cap", type=int, default=4,
                    help="hot-engine cache capacity (LRU entries)")
    ap.add_argument("--poll-s", type=float, default=0.2,
                    help="idle inbox poll interval")
    ap.add_argument("--ckpt-every-s", type=float, default=60.0,
                    help="batch checkpoint throttle (drains force one "
                         "regardless)")
    ap.add_argument("--log-level", default="message",
                    choices=["error", "warning", "message", "info",
                             "debug"])
    args = ap.parse_args(argv)

    # ServeDaemon resolves the device first: with no card and no --device
    # it raises (the port never serves on the CPU unasked).
    try:
        daemon = ServeDaemon(
            args.spool, metrics_port=args.metrics_port,
            max_lanes=args.max_lanes, cache_capacity=args.cache_cap,
            poll_s=args.poll_s, ckpt_every_s=args.ckpt_every_s,
            log_level=args.log_level, queue_depth=args.queue_depth,
            queue_bytes=args.queue_bytes,
            retry_max=args.retry_max, device=args.device).start()
    except SpoolError as e:
        print(f"SpoolError: {e}", file=sys.stderr, flush=True)
        print(json.dumps({"error": "serve_spool", "message": str(e)}))
        return EXIT_SERVE_SPOOL
    try:
        return daemon.run()
    except DeviceLostError as e:
        print(f"DeviceLostError: {e}", file=sys.stderr, flush=True)
        print(json.dumps({"error": "device_lost", "message": str(e)[:800]}))
        return 1


if __name__ == "__main__":
    sys.exit(main())

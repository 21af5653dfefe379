"""Serve wire protocol — the job spool layout and the socket framing (port
of ``serve/protocol.py``: the same files, records and framing, so either
package's client reads a spool the other's daemon serves).

One source of truth for everything the daemon and the client must agree
on: where job files live, what a job/status record contains, which states
a job moves through, and how JSON lines frame the Unix-socket requests.
Both transports are CI-testable on CPU; the spool alone is sufficient
(the socket is a convenience for streaming watches and liveness checks —
every submission lands as a spool file either way, so there is exactly
one accept path for the daemon to make atomic).

Spool layout (``--spool DIR``)::

    DIR/
      inbox/<job_id>.json     submissions (written via write_json_atomic:
                              fsynced temp + rename — a client or daemon
                              killed mid-submit can never leave a torn
                              job record; ``.tmp`` files are invisible to
                              the scan)
      jobs/<job_id>/job.json      the accepted job record (atomic move
                                  out of the inbox — accept is one
                                  os.replace, kill-safe)
      jobs/<job_id>/status.json   current state (atomic rewrite at every
                                  transition)
      jobs/<job_id>/result.jsonl  the per-job record stream: ring rows
                                  (digest words included), quarantine /
                                  finalize events, the final fleet_exp
      batches/                    in-flight batch checkpoints (lineage
                                  generations; evicted batches resume
                                  from here)
      queue.json              persisted scheduler state (graceful
                              shutdown / restart)
      serve.log               the daemon's own JSONL event stream
                              (REC_SERVE / REC_SERVE_JOB records —
                              tools/heartbeat_report.py's serve section)
      daemon.json             daemon liveness: host / pid / socket path /
                              start / heartbeat (mtime refreshed every
                              HEARTBEAT_S — the stale-lock protocol)
      daemon.lock             fcntl flock held for the daemon's lifetime
                              (kernel-released on death; never parsed)
      serve.sock              the Unix socket

Deliberately torch-free: the client, report tools and tests import this
without paying an accelerator import.
"""

from __future__ import annotations

import fcntl
import json
import os
import socket
import time

from shadow1_tpu_torch.lineage import write_json_atomic

SPOOL_VERSION = 1

# Job lifecycle states (the serve_job records' ``state`` field).
J_QUEUED = "queued"      # admitted; waiting for a lane
J_WAITING = "waiting_headroom"  # admitted (fits an idle device) but the
#                          resident batch leaves too little live headroom;
#                          scheduled as soon as resident bytes drain —
#                          never rejected just because someone else runs
J_RUNNING = "running"    # riding a lane of the in-flight fleet batch
J_DONE = "done"          # finished; final fleet_exp in result.jsonl
J_FAILED = "failed"      # quarantined lane / runtime error / deadline
#                          expiry / retries exhausted (reason says)
J_REJECTED = "rejected"  # refused at admission (config / memory budget /
#                          queue_full backpressure)
J_EVICTED = "evicted"    # preempted by a higher-priority tenant;
#                          automatically requeued (transient state —
#                          the job returns to queued with its batch
#                          checkpoint as the resume cursor)
TERMINAL_STATES = (J_DONE, J_FAILED, J_REJECTED)

# Spool-lock liveness protocol (NFS-safe ownership). The daemon holds an
# fcntl flock on DIR/daemon.lock for its whole lifetime — on one host,
# kernel lock release on process death makes takeover race-free. Across
# hosts (an NFS spool where flock may not propagate) daemon.json's
# host/pid plus a heartbeat (the daemon touches daemon.json's mtime every
# HEARTBEAT_S) decide: same host → the pid check is authoritative;
# different host → a heartbeat older than STALE_AFTER_S marks the holder
# dead and the spool reclaimable.
HEARTBEAT_S = 5.0
STALE_AFTER_S = 30.0


def new_job_id() -> str:
    """Collision-safe, sortable-by-submission job id."""
    return f"{time.time_ns():016x}-{os.urandom(3).hex()}"


class Spool:
    """Path arithmetic + atomic record IO for one spool directory."""

    def __init__(self, root: str):
        self.root = root
        self.inbox = os.path.join(root, "inbox")
        self.jobs = os.path.join(root, "jobs")
        self.batches = os.path.join(root, "batches")
        self.queue_path = os.path.join(root, "queue.json")
        self.log_path = os.path.join(root, "serve.log")
        self.daemon_path = os.path.join(root, "daemon.json")
        self.lock_path = os.path.join(root, "daemon.lock")
        self.sock_path = os.path.join(root, "serve.sock")

    def ensure(self) -> "Spool":
        for d in (self.root, self.inbox, self.jobs, self.batches):
            os.makedirs(d, exist_ok=True)
        return self

    # -- job paths ---------------------------------------------------------

    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.jobs, job_id)

    def job_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), "job.json")

    def status_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), "status.json")

    def result_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), "result.jsonl")

    # -- submission (client side) -----------------------------------------

    def submit(self, job: dict) -> str:
        """Write ``job`` into the inbox atomically; returns the job id.
        The ONLY submission path — the socket's submit op calls this too,
        so a kill at any instant leaves either no file or a whole one."""
        job_id = job.get("id") or new_job_id()
        job = {**job, "id": job_id, "spool_version": SPOOL_VERSION}
        os.makedirs(self.inbox, exist_ok=True)
        write_json_atomic(os.path.join(self.inbox, job_id + ".json"), job)
        return job_id

    def scan_inbox(self) -> list[tuple[str, dict | None]]:
        """(path, job-or-None) for every inbox entry, submission order.
        ``None`` marks an unparseable file (hand-written, wrong schema) —
        the atomic-write contract means it was never OUR torn write, so
        the daemon rejects it instead of crashing on it."""
        try:
            names = sorted(os.listdir(self.inbox))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json"):
                continue  # .tmp of an in-flight atomic write, stray files
            path = os.path.join(self.inbox, name)
            try:
                with open(path) as f:
                    job = json.load(f)
                if not isinstance(job, dict) or "config_yaml" not in job:
                    job = None
            except (OSError, ValueError):
                job = None
            out.append((path, job))
        return out

    def accept(self, inbox_path: str, job: dict) -> None:
        """Move an inbox submission into its job directory — one
        os.replace, so a daemon killed mid-accept leaves the record
        intact on exactly one side, never torn or duplicated."""
        os.makedirs(self.job_dir(job["id"]), exist_ok=True)
        os.replace(inbox_path, self.job_path(job["id"]))

    # -- status / results --------------------------------------------------

    def write_status(self, job_id: str, status: dict) -> None:
        os.makedirs(self.job_dir(job_id), exist_ok=True)
        write_json_atomic(self.status_path(job_id),
                          {"type": "serve_job", "job": job_id,
                           "updated_at": time.time(), **status})

    def read_status(self, job_id: str) -> dict | None:
        try:
            with open(self.status_path(job_id)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def append_result(self, job_id: str, rec: dict) -> None:
        os.makedirs(self.job_dir(job_id), exist_ok=True)
        with open(self.result_path(job_id), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read_results(self, job_id: str) -> list[dict]:
        try:
            with open(self.result_path(job_id)) as f:
                return [json.loads(line) for line in f if line.strip()]
        except OSError:
            return []

    # -- daemon liveness / spool ownership ---------------------------------

    def daemon_info(self) -> dict | None:
        try:
            with open(self.daemon_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def acquire_lock(self) -> int | None:
        """Take the spool's fcntl lock (DIR/daemon.lock) non-blocking;
        returns the held fd — the caller keeps it open for the daemon's
        lifetime (the kernel releases it on ANY process death, including
        SIGKILL) — or None when a live same-host daemon already holds it.
        Holding the flock alone is not ownership: an NFS holder on
        another host may not be visible through flock, so the caller must
        still consult :meth:`holder_liveness` before reclaiming."""
        fd = os.open(self.lock_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return None
        return fd

    def holder_liveness(self, stale_after_s: float = STALE_AFTER_S
                        ) -> tuple[str, dict | None]:
        """('absent'|'live'|'stale', daemon.json info) — the heartbeat /
        pid stale-lock protocol. Same host: a dead pid is stale no matter
        how fresh the heartbeat (a SIGKILLed daemon can't clean up); a
        live pid counts only with a fresh heartbeat, guarding against pid
        recycling. Different host (NFS spool): the heartbeat mtime is the
        only signal — fresh means live, stale means reclaimable."""
        info = self.daemon_info()
        if not info:
            return "absent", None
        hb = 0.0
        for key in ("heartbeat_at", "started_at"):
            try:
                hb = max(hb, float(info.get(key) or 0))
            except (TypeError, ValueError):
                pass
        try:
            hb = max(hb, os.path.getmtime(self.daemon_path))
        except OSError:
            pass
        fresh = (time.time() - hb) < stale_after_s
        same_host = info.get("host") in (None, socket.gethostname())
        if same_host:
            try:
                os.kill(int(info["pid"]), 0)
            except (OSError, ValueError, KeyError, TypeError):
                return "stale", info
            return ("live" if fresh else "stale"), info
        return ("live" if fresh else "stale"), info

    def touch_heartbeat(self) -> None:
        """Refresh the liveness heartbeat (daemon.json's mtime — the
        cross-host half of the stale-lock protocol)."""
        try:
            os.utime(self.daemon_path)
        except OSError:
            pass

    def daemon_alive(self) -> dict | None:
        """The live daemon's info record, or None. Stale daemon.json
        (dead pid, or a heartbeat past STALE_AFTER_S — a SIGKILLed
        daemon can't clean up) reads as absent, so a restart can always
        take the spool over."""
        liveness, info = self.holder_liveness()
        return info if liveness == "live" else None


# ---------------------------------------------------------------------------
# Socket framing: newline-delimited JSON, request → response(s). Ops:
#   {"op": "ping"}                → {"ok": true, "ledger": {...}}
#   {"op": "submit", "job": {..}} → {"ok": true, "id": "..."}
#   {"op": "status", "id": "..."} → the job's status record
#   {"op": "watch",  "id": "..."} → status records streamed until terminal
#   {"op": "shutdown"}            → {"ok": true}; daemon drains + exits
# ---------------------------------------------------------------------------

def send_line(sock_file, obj: dict) -> None:
    sock_file.write(json.dumps(obj) + "\n")
    sock_file.flush()


def request(sock_path: str, obj: dict, timeout_s: float = 10.0) -> dict:
    """One request → one response over the daemon's Unix socket."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout_s)
        s.connect(sock_path)
        f = s.makefile("rw", encoding="utf-8")
        send_line(f, obj)
        line = f.readline()
        if not line:
            raise ConnectionError("daemon closed the connection")
        return json.loads(line)

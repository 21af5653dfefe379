"""Submit client — ``python -m shadow1_tpu_torch submit CONFIG --spool DIR``
(port of ``serve/client.py``).

Submits one experiment config (YAML, or JSON, which the card's machine
reads without a YAML parser) to a serve daemon, streams its status
transitions to stderr, tails the per-job record stream (ring/digest rows,
the final ``fleet_exp``) to stdout, and exits the solo CLI's taxonomy: ``EXIT_OK`` on success, ``EXIT_CONFIG`` for a
config rejection, ``EXIT_MEMORY`` for an admission (memory-budget)
rejection, ``EXIT_CAPACITY`` when the job's lane was quarantined on a
capacity halt, ``EXIT_QUEUE_FULL`` for a backpressure rejection (the
record carries ``retry_after_s`` — back off and resubmit), and
``EXIT_DEADLINE`` when --queue-ttl-s / --deadline-s expired the job —
so scripting against the daemon reads exactly like scripting against
``python -m shadow1_tpu_torch``.

Submission always lands as an atomic spool-inbox file (ONE accept path
for the daemon to make kill-safe); the Unix socket, when live, is used
to nudge the scheduler and to stream status without polling. torch-free —
submitting costs no accelerator import.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

from shadow1_tpu_torch.consts import (
    EXIT_CAPACITY,
    EXIT_CONFIG,
    EXIT_DEADLINE,
    EXIT_MEMORY,
    EXIT_OK,
    EXIT_QUEUE_FULL,
)
from shadow1_tpu_torch.serve.protocol import (
    J_DONE,
    J_FAILED,
    J_REJECTED,
    TERMINAL_STATES,
    Spool,
    new_job_id,
    request,
)


def exit_code_for(status: dict) -> int:
    """Terminal job status → the solo CLI's exit taxonomy."""
    state = status.get("state")
    if state == J_DONE:
        return EXIT_OK
    err = status.get("error") or {}
    kind = err.get("error")
    if state == J_REJECTED:
        if kind == "queue_full":
            return EXIT_QUEUE_FULL
        return EXIT_MEMORY if kind == "memory_budget" else EXIT_CONFIG
    if state == J_FAILED:
        if status.get("reason") == "deadline_expired" \
                or kind == "deadline_expired":
            return EXIT_DEADLINE
        if status.get("reason") == "capacity" or kind == "capacity":
            return EXIT_CAPACITY
        if status.get("reason") == "memory_exhausted" \
                or kind == "memory_exhausted":
            return EXIT_MEMORY
    return 1


def request_retry(sock_path: str, obj: dict, attempts: int = 4,
                  base_s: float = 0.05, timeout_s: float = 10.0,
                  say=None) -> dict:
    """``protocol.request`` with bounded reconnect: OSError /
    ConnectionError retries with jittered exponential backoff (a daemon
    mid-restart, a flapping socket), and a success after a failure
    surfaces a ``reconnected`` stderr event so tenants can SEE the flap
    instead of silently degrading. Raises the last error when every
    attempt fails."""
    say = say or (lambda *a: None)
    last = None
    for attempt in range(max(int(attempts), 1)):
        if attempt:
            delay = base_s * (2 ** (attempt - 1))
            time.sleep(delay * (0.5 + random.random()))
        try:
            out = request(sock_path, obj, timeout_s=timeout_s)
        except (OSError, ConnectionError, ValueError) as e:
            last = e
            continue
        if attempt:
            evt = {"type": "serve", "event": "reconnected",
                   "attempt": attempt + 1, "sock": sock_path}
            print(json.dumps(evt), file=sys.stderr, flush=True)
            say(f"[submit] reconnected to {sock_path} "
                f"(attempt {attempt + 1})")
        return out
    raise last if last is not None else ConnectionError(
        f"no response from {sock_path}")


def watch(sock_path: str, job_id: str, on_status=None,
          timeout_s: float = 600.0, attempts: int = 4,
          base_s: float = 0.1, say=None) -> dict | None:
    """Stream a job's status transitions over the daemon's watch op,
    reconnecting (bounded, jittered backoff) when the stream breaks
    mid-flight; a reconnect surfaces the same ``reconnected`` stderr
    event as :func:`request_retry`. Returns the terminal status, or
    None when the socket path is exhausted — callers fall back to spool
    polling (await_job), which needs no daemon at all."""
    import socket as socketlib

    say = say or (lambda *a: None)
    deadline = time.monotonic() + timeout_s
    failures = 0
    while time.monotonic() < deadline and failures < max(int(attempts), 1):
        try:
            with socketlib.socket(socketlib.AF_UNIX,
                                  socketlib.SOCK_STREAM) as s:
                s.settimeout(max(deadline - time.monotonic(), 1.0))
                s.connect(sock_path)
                f = s.makefile("rw", encoding="utf-8")
                f.write(json.dumps({"op": "watch", "id": job_id}) + "\n")
                f.flush()
                if failures:
                    evt = {"type": "serve", "event": "reconnected",
                           "attempt": failures + 1, "sock": sock_path}
                    print(json.dumps(evt), file=sys.stderr, flush=True)
                    say(f"[submit] reconnected to {sock_path} "
                        f"(attempt {failures + 1})")
                    failures = 0
                while time.monotonic() < deadline:
                    line = f.readline()
                    if not line:
                        raise ConnectionError("watch stream closed")
                    st = json.loads(line)
                    if st.get("ok") is False:
                        return None  # daemon-side refusal; fall back
                    if on_status is not None:
                        on_status(st)
                    if st.get("state") in TERMINAL_STATES:
                        return st
        except (OSError, ConnectionError, ValueError):
            failures += 1
            delay = base_s * (2 ** (failures - 1))
            time.sleep(delay * (0.5 + random.random()))
    return None


class _ResultTail:
    """Incremental reader of a job's append-only result.jsonl: remembers
    the byte offset of the last complete line, so each poll reads only
    the new tail instead of re-parsing the whole stream (a long job
    accumulates thousands of ring rows). A daemon restarted after a
    SIGKILL truncates and rewrites the file from scratch — a shrinking
    file resets the offset."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self._ino = None

    def new_records(self) -> list[dict]:
        try:
            stat = os.stat(self.path)
        except OSError:
            return []
        if stat.st_ino != self._ino or stat.st_size < self.offset:
            # A different inode (the daemon's from-scratch rerun removed
            # and rewrote the file — size alone can already have regrown
            # past the old offset by the time we poll) or a shrink: start
            # over from byte 0.
            self.offset = 0
            self._ino = stat.st_ino
        if stat.st_size == self.offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            chunk = f.read()
        # Consume only whole lines; a partially-appended tail stays for
        # the next poll (writes are line-atomic on close, but a read can
        # land mid-append).
        cut = chunk.rfind(b"\n") + 1
        self.offset += cut
        out = []
        for line in chunk[:cut].splitlines():
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out


def await_job(spool: Spool, job_id: str, timeout_s: float = 600.0,
              poll_s: float = 0.2, on_status=None,
              stream_results=None) -> dict:
    """Poll the spool until the job reaches a terminal state; returns the
    final status. ``on_status`` sees every observed transition;
    ``stream_results`` sees each result record once, as it lands."""
    deadline = time.monotonic() + timeout_s
    last = None
    tail = _ResultTail(spool.result_path(job_id))
    while True:
        if stream_results is not None:
            for rec in tail.new_records():
                stream_results(rec)
        st = spool.read_status(job_id)
        if st is not None and st != last:
            if on_status is not None:
                on_status(st)
            last = st
        if st is not None and st.get("state") in TERMINAL_STATES:
            if stream_results is not None:
                for rec in tail.new_records():
                    stream_results(rec)
            return st
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"job {job_id} not terminal after {timeout_s}s "
                f"(last state: {(st or {}).get('state')!r})")
        time.sleep(poll_s)


def submit(spool_dir: str, config_path: str, priority: int = 0,
           windows: int | None = None, job_id: str | None = None,
           queue_ttl_s: float | None = None,
           deadline_s: float | None = None) -> str:
    """Submit one config; returns the job id. Spool-file submission with
    a socket nudge when the daemon is live."""
    spool = Spool(spool_dir)
    with open(config_path) as f:
        config_yaml = f.read()
    job = {
        "id": job_id or new_job_id(),
        "config_yaml": config_yaml,
        "base_dir": os.path.dirname(os.path.abspath(config_path)),
        "config_name": os.path.basename(config_path),
        "priority": int(priority),
        "submitted_at": time.time(),
    }
    if windows is not None:
        job["windows"] = int(windows)
    if queue_ttl_s is not None:
        job["queue_ttl_s"] = float(queue_ttl_s)
    if deadline_s is not None:
        job["deadline_s"] = float(deadline_s)
    jid = spool.submit(job)
    info = spool.daemon_alive()
    if info:
        try:  # nudge only — the inbox file IS the submission
            request_retry(info.get("sock", spool.sock_path),
                          {"op": "ping"}, attempts=3, timeout_s=2.0)
        except (OSError, ValueError, ConnectionError):
            pass
    return jid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m shadow1_tpu_torch submit",
        description="submit a job to a serve daemon and await the result")
    ap.add_argument("config", help="YAML or JSON experiment file")
    ap.add_argument("--spool", required=True, metavar="DIR",
                    help="the daemon's spool directory")
    ap.add_argument("--priority", type=int, default=0,
                    help="scheduling priority (higher preempts: a "
                         "strictly-higher submission EVICTS a running "
                         "batch through the preemption plane)")
    ap.add_argument("--windows", type=int, default=None,
                    help="run only this many conservative windows")
    ap.add_argument("--queue-ttl-s", type=float, default=None,
                    metavar="S",
                    help="expire the job if it has not STARTED within S "
                         "seconds of admission (terminal "
                         "deadline_expired record, EXIT_DEADLINE)")
    ap.add_argument("--deadline-s", type=float, default=None, metavar="S",
                    help="bound the job's running wall time: past S the "
                         "daemon drains it at the next chunk boundary — "
                         "the result stream keeps the committed prefix "
                         "(bit-identical to the same prefix of a solo "
                         "run) and the job exits EXIT_DEADLINE")
    ap.add_argument("--no-wait", action="store_true",
                    help="submit and print the job id without awaiting")
    ap.add_argument("--timeout-s", type=float, default=600.0,
                    help="--wait deadline")
    ap.add_argument("--json-only", action="store_true",
                    help="suppress status prose on stderr")
    args = ap.parse_args(argv)

    spool = Spool(args.spool)
    if not os.path.isdir(spool.root):
        print(f"submit: spool {spool.root} does not exist (start the "
              f"daemon first: python -m shadow1_tpu_torch serve --spool "
              f"{spool.root})", file=sys.stderr, flush=True)
        return EXIT_CONFIG
    job_id = submit(args.spool, args.config, priority=args.priority,
                    windows=args.windows, queue_ttl_s=args.queue_ttl_s,
                    deadline_s=args.deadline_s)
    if not args.json_only:
        print(f"[submit] job {job_id} -> {spool.root}"
              + ("" if spool.daemon_alive() else
                 " (no live daemon — it will run on the next start)"),
              file=sys.stderr, flush=True)
    if args.no_wait:
        print(json.dumps({"type": "serve_job", "job": job_id,
                          "state": "submitted"}))
        return EXIT_OK

    say = (lambda *a: None) if args.json_only else (
        lambda *a: print(*a, file=sys.stderr, flush=True))

    def on_status(st):
        say(f"[submit] {job_id}: {st.get('state')}"
            + (f" (lane {st['lane']}/{st['lanes']}, cache "
               f"{st.get('cache')})" if st.get("state") == "running"
               and "lane" in st else ""))

    # Status prose rides the socket watch when a daemon is live (prompt
    # transitions + visible reconnects on flaps); completion and the
    # result stream ALWAYS come from the spool files — the path that
    # needs no daemon and survives restarts.
    info = spool.daemon_alive()
    if info:
        import threading

        threading.Thread(
            target=watch,
            args=(info.get("sock", spool.sock_path), job_id),
            kwargs={"on_status": on_status, "timeout_s": args.timeout_s,
                    "say": say},
            daemon=True).start()
        poll_status = None
    else:
        poll_status = on_status

    try:
        final = await_job(
            spool, job_id, timeout_s=args.timeout_s,
            on_status=poll_status,
            stream_results=lambda rec: print(json.dumps(rec), flush=True))
    except TimeoutError as e:
        print(f"submit: {e}", file=sys.stderr, flush=True)
        return 1
    if final.get("state") == J_REJECTED:
        err = final.get("error") or {}
        say(f"[submit] rejected: "
            f"{err.get('message') or err.get('advice') or err}")
    print(json.dumps(final))
    return exit_code_for(final)


if __name__ == "__main__":
    sys.exit(main())

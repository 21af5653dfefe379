"""Preemption plane — signal-driven graceful drain (port of
``preempt.py``).

The first SIGTERM/SIGINT *requests a drain*: the chunk runner
(``ckpt.run_chunked``, via ``obs.run_with_heartbeat``) finishes the
in-flight chunk, commits it, forces a final snapshot and raises
:class:`PreemptedExit`; the CLI exits with ``consts.EXIT_PREEMPTED`` and a
parseable stdout record, and the supervisor classifies that exit as
clean-resume (no backoff, no crash accounting, checkpoint kept).
Rerunning the same command resumes bit-identically.

Signals are host-side: the handler only sets a flag, sampled at chunk
boundaries, never inside a window. The final snapshot goes through
``ckpt.save_state``, which copies every leaf to the host, so the device's
queued work has finished before the snapshot is written.

A second signal arriving ≥ :data:`FORCE_GRACE_S` after the first forces
an immediate default-action exit; one closer is a duplicate delivery
(process-group delivery plus the supervisor's forward) and is ignored.
"""

from __future__ import annotations

import os
import signal
import sys
import time

from shadow1_tpu_torch.consts import EXIT_PREEMPTED  # noqa: F401 (re-export)

# Duplicate-delivery debounce: signals closer together than this are one
# logical drain request; later ones escalate to an immediate exit.
FORCE_GRACE_S = 1.0

_DRAIN_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptedExit(Exception):
    """A drain request was honored: the in-flight chunk is committed (and
    checkpointed, when the run carries a checkpoint path) — the process
    should now exit :data:`EXIT_PREEMPTED`.

    Carries the committed state and the progress the CLI's stdout record
    reports: ``signame``, ``done_windows`` (committed this invocation),
    ``win_start`` (absolute sim clock, the resume point), ``ckpt`` and
    ``generation`` (lineage sequence number of the final snapshot)."""

    def __init__(self, st=None, signame: str = "SIGTERM",
                 done_windows: int = 0, win_start: int = 0,
                 ckpt: str | None = None, generation: int | None = None):
        self.st = st
        self.signame = signame
        self.done_windows = int(done_windows)
        self.win_start = int(win_start)
        self.ckpt = ckpt
        self.generation = generation
        super().__init__(
            f"drain complete after {signame}: {self.done_windows} window(s) "
            f"committed, sim_ns={self.win_start}"
            + (f", snapshot {ckpt}" if ckpt else ", no checkpoint path"))


def run_injection_hooks(sim_ns: int) -> None:
    """Chunk-boundary fault, preemption and hang injection, inert without
    the env vars:

    * ``SHADOW1_OBS_CRASH_PRE_SAVE_AT_NS`` — die before the checkpoint is
      written (the supervisor sees a zero-progress crash);
    * ``SHADOW1_OBS_SIGTERM_SELF_AT_NS`` — deliver SIGTERM to ourselves
      (the deterministic twin of a real preemption notice);
    * ``SHADOW1_OBS_HANG_AT_NS`` (+ ``SHADOW1_OBS_HANG_ONCE_FLAG``) — stop
      updating the progress sidecar while staying alive (the shape the
      watchdog must detect); the flag file makes it fire once, so a
      respawn proceeds.

    The post-save crash hook (``SHADOW1_OBS_CRASH_AT_NS``) stays in
    ``obs.run_with_heartbeat``: it is gated on a save having happened."""
    crash_pre = os.environ.get("SHADOW1_OBS_CRASH_PRE_SAVE_AT_NS")
    if crash_pre is not None and sim_ns == int(crash_pre):
        os._exit(41)
    sigterm_at = os.environ.get("SHADOW1_OBS_SIGTERM_SELF_AT_NS")
    if sigterm_at is not None and sim_ns == int(sigterm_at):
        os.kill(os.getpid(), signal.SIGTERM)
    hang_at = os.environ.get("SHADOW1_OBS_HANG_AT_NS")
    if hang_at is not None and sim_ns == int(hang_at):
        flag = os.environ.get("SHADOW1_OBS_HANG_ONCE_FLAG")
        if flag is None or not os.path.exists(flag):
            if flag:
                with open(flag, "w") as f:
                    f.write("hung")
            while True:
                time.sleep(3600)


class DrainHandler:
    """Installable SIGTERM/SIGINT drain-request latch.

    ``requested`` flips on the first signal; the chunk runner polls it at
    chunk boundaries (never inside a window — a window is the atomic unit
    of the determinism contract). The handler only sets a flag: the drain
    work happens at the boundary, on the main thread."""

    def __init__(self, log=None):
        self.signame: str | None = None
        self._t_first: float | None = None
        self._log = log
        self._prev: dict[int, object] = {}

    @property
    def requested(self) -> bool:
        return self.signame is not None

    def _handle(self, signum, frame):
        now = time.monotonic()
        if self._t_first is not None and now - self._t_first >= FORCE_GRACE_S:
            # A genuine second request: restore the default action and
            # re-raise, so the process dies with 128+signum — a crash to
            # the supervisor, not a drain.
            print(f"[preempt] second {signal.Signals(signum).name} — "
                  f"abandoning drain, exiting immediately",
                  file=sys.stderr, flush=True)
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        if self._t_first is None:
            self.signame = signal.Signals(signum).name
            self._t_first = now
            print(f"[preempt] {self.signame} received — draining: finishing "
                  f"the in-flight chunk, committing, writing a final "
                  f"snapshot (send again in >{FORCE_GRACE_S:.0f}s to force "
                  f"exit)", file=sys.stderr, flush=True)

    def install(self) -> "DrainHandler":
        for sig in _DRAIN_SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

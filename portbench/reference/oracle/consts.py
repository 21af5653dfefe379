"""Shared constants and engine parameters — the PyTorch port's own copy.

A verbatim copy of the JAX package's ``shadow1_tpu/consts.py`` (the port
imports nothing of that package), so one YAML file means the same thing to
both: event kinds, packet flags, capacity limits, TCP constants and the
whole ``EngineParams`` are defined identically. Keep the two in step. The
simulated system keeps the analogous definitions in
``src/main/core/work/event.c`` (event ordering),
``src/main/routing/packet.c`` (header fields/flags) and
``src/main/host/descriptor/tcp.c`` (TCP constants).
"""

from __future__ import annotations

import dataclasses

# --------------------------------------------------------------------------
# CLI exit-code taxonomy (docs/SEMANTICS.md "Preemption contract", README).
# One table, defined in this jax-free module so the supervisor, the child,
# report tools and the tests all read the SAME codes — never magic ints.
# Any other nonzero exit is an unclassified crash (Python tracebacks exit 1;
# a signal death surfaces as 128+signum / negative returncode).
# --------------------------------------------------------------------------
EXIT_OK = 0          # run completed
EXIT_CONFIG = 2      # rejected before running: bad flags/config (argparse's
                     # own error code; structured FleetConfigError exits)
EXIT_CAPACITY = 4    # --on-overflow halt raised CapacityExceededError —
                     # deterministic config condition, supervisor never
                     # respawns (the child printed paste-ready cap advice)
EXIT_PREEMPTED = 5   # SIGTERM/SIGINT drain: the in-flight chunk was
                     # committed, a final snapshot written, and a parseable
                     # {"preempted": ...} record printed — the supervisor
                     # classifies this as clean-resume (no backoff, no crash
                     # accounting; rerun the same command to continue)
EXIT_HUNG = 6        # supervisor abort: the child's progress sidecar went
                     # stale past --watchdog-s twice consecutively with no
                     # forward progress — a deterministic wedge, not a
                     # transient device fault (see the no-kill probe
                     # playbook: tools/faultprobe)
EXIT_MEMORY = 7      # memory plane (shadow1_tpu/mem.py): the pre-flight
                     # byte budget rejected an oversubscribed config
                     # (MemoryBudgetError, per-plane attribution + paste-
                     # ready advice printed), or the runtime caught a
                     # RESOURCE_EXHAUSTED device OOM — either way a
                     # deterministic config-vs-device condition the
                     # supervisor never respawns into
EXIT_SERVE_SHUTDOWN = 8  # serve plane (shadow1_tpu/serve/): the daemon
                     # drained cleanly after SIGTERM/SIGINT (or a socket
                     # shutdown op) — the in-flight batch committed and
                     # checkpointed, every queued job persisted to the
                     # spool's queue.json; restarting the daemon on the
                     # same --spool resumes exactly where it left off
EXIT_SERVE_SPOOL = 9  # serve plane: the daemon REFUSED to start — the
                     # --spool directory is unusable (unwritable, torn
                     # beyond repair) or another live daemon already owns
                     # it (flock held, or daemon.json names a live holder
                     # under the heartbeat/pid stale-lock protocol; a
                     # SIGKILLed holder's leftovers classify stale and
                     # are reclaimed instead). Job submissions never use
                     # this code: a rejected job exits the submit client
                     # with EXIT_CONFIG / EXIT_MEMORY like the solo CLI
EXIT_QUEUE_FULL = 10  # serve plane backpressure: the job FITS an idle
                     # device but the daemon's bounded queue (--queue-depth
                     # / --queue-bytes) is at capacity — structured
                     # ``error=queue_full`` rejection carrying
                     # ``retry_after_s`` advice; resubmit after backing
                     # off (never a silent drop, never an OOM for the
                     # tenants already running)
EXIT_DEADLINE = 11   # serve plane deadlines: the job expired — either
                     # still waiting past --queue-ttl-s, or running past
                     # --deadline-s (drained at a chunk boundary; the
                     # result stream keeps the committed prefix, bit-
                     # identical to the same prefix of a straight run)

EXIT_CODES: dict[int, str] = {
    EXIT_OK: "ok",
    EXIT_CONFIG: "config rejected (flags/schema/fleet contract)",
    EXIT_CAPACITY: "capacity halt (CapacityExceededError, advice printed)",
    EXIT_PREEMPTED: "preempted (graceful drain; resume to continue)",
    EXIT_HUNG: "hung (watchdog killed a stale child twice, no progress)",
    EXIT_MEMORY: "memory (over HBM budget / RESOURCE_EXHAUSTED, advice printed)",
    EXIT_SERVE_SHUTDOWN: "serve daemon drained (queue persisted; restart to resume)",
    EXIT_SERVE_SPOOL: "serve daemon refused to start (spool unusable or owned)",
    EXIT_QUEUE_FULL: "serve queue full (backpressure; retry_after_s advice printed)",
    EXIT_DEADLINE: "serve deadline expired (queue TTL or running --deadline-s)",
}

# --------------------------------------------------------------------------
# Simulation time: int64 nanoseconds (reference SimulationTime is 1ns ticks).
# --------------------------------------------------------------------------
NS = 1
US = 1_000
MS = 1_000_000
SEC = 1_000_000_000

# --------------------------------------------------------------------------
# Event kinds. The reference dispatches closures (Task = fn + args,
# src/main/core/work/task.c); a tensorized engine needs a closed enum of
# handler kinds instead.
# --------------------------------------------------------------------------
K_NONE = 0        # empty slot
K_PHOLD = 1       # PHOLD benchmark hop (engine stress workload, SURVEY §4)
K_PKT = 2         # packet arrived at dst NIC (pre receive-queue)
K_PKT_DELIVER = 3 # packet cleared the NIC receive token bucket; process it
K_TCP_TIMER = 4   # per-socket retransmit timer check
K_TX_RESUME = 5   # continue flushing a socket's send buffer (burst bound)
K_APP = 6         # application state-machine wakeup (p0 = app opcode)
N_KINDS = 7

# Per-kind occupancy metric fields shared by both engines (kind →
# (pops-field, fires-field)): one table so the engines cannot drift.
KIND_METRIC_FIELDS = {
    K_PKT: ("pops_pkt", "fires_pkt"),
    K_PKT_DELIVER: ("pops_deliver", "fires_deliver"),
    K_TCP_TIMER: ("pops_timer", "fires_timer"),
    K_TX_RESUME: ("pops_txr", "fires_txr"),
    K_APP: ("pops_app", "fires_app"),
}

# Human-readable kind names — the phase attribution plane's handler-pass
# labels (jax.named_scope spans in core/engine.run_round, the per-pass rows
# of tools/opcensus.py and tools/phaseprobe.py).
KIND_NAMES = {
    K_NONE: "none",
    K_PHOLD: "phold",
    K_PKT: "pkt",
    K_PKT_DELIVER: "deliver",
    K_TCP_TIMER: "timer",
    K_TX_RESUME: "txr",
    K_APP: "app",
}

# Number of i32 payload columns on every event record.
NP = 10

# --------------------------------------------------------------------------
# Packet header flags (rides in the packed p1 column, bits 16..23).
# --------------------------------------------------------------------------
F_SYN = 1
F_ACK = 2
F_FIN = 4
F_RST = 8
F_DGRAM = 16      # datagram (UDP-like) — delivered straight to the app

# Packet event payload layout (p0..p9) — see docs/SEMANTICS.md:
#   p0 = src_host
#   p1 = src_sock | dst_sock << 8 | flags << 16
#   p2 = seq   (u32 wrapping byte offset, stored in i32)
#   p3 = ack   (u32 wrapping)
#   p4 = len   (payload bytes modeled; no actual bytes are carried)
#   p5 = wnd   (advertised receive window, bytes)
#   p6 = msg_end (u32 wrapping stream offset at which a message completes;
#                 0 sentinel = no message boundary in this segment)
#   p7 = msg_meta (opaque app metadata for that message)
#   p8, p9 = app scratch (datagrams: p8 = meta2)

# Event tie-break key classes (tb column, i64). Pop order is (time, tb)
# lexicographic — engine-independent, matching the reference's total event
# order (time, host, seq) in src/main/core/work/event.c (host is implicit
# here: buffers are per-host already).
TB_PACKET_BASE = 1 << 62  # packets order after same-time local events


def packet_tb(src_host: int, src_ctr: int) -> int:
    """Deterministic tie-break for a delivered packet event.

    Depends only on (src_host, per-src packet counter), so the CPU oracle
    (which schedules arrivals eagerly at send time) and the TPU engine
    (which scatters arrivals at window end) assign identical keys.
    """
    return TB_PACKET_BASE + (src_host << 32) + (src_ctr & 0xFFFFFFFF)


# --------------------------------------------------------------------------
# RNG purpose domains (counter-based keys: fold_in(seed, purpose, host, ctr)).
# Draws are order-independent so both engines reproduce identical streams.
# The reference gives each host a seeded RNG (src/main/host/host.c).
# --------------------------------------------------------------------------
R_PHOLD_DELAY = 1
R_PHOLD_DST = 2
R_LOSS = 3
R_APP = 4
R_TOR_PATH = 5
R_BTC = 6
R_JITTER = 7  # per-packet edge-latency jitter (ctr = src pkt counter)
R_AQM = 8     # RED early-drop coin (ctr = per-host uplink attempt counter)


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Static engine capacities and protocol constants.

    Shape-affecting fields are static (hashable dataclass → usable as a jit
    static argument). Both engines honour the same capacity bounds, but *which*
    items drop on overflow is engine-specific (eager order vs window-batch rank)
    — cross-engine parity is guaranteed only when the overflow counters are 0,
    which is what the metrics exist to police (docs/SEMANTICS.md §capacities).
    """

    # Per-host event buffer capacity (slots).
    ev_cap: int = 64
    # Per-host per-window packet outbox capacity.
    outbox_cap: int = 64
    # Sockets per host.
    sockets_per_host: int = 16
    # Per-socket in-flight message-boundary FIFO capacity.
    msgq_cap: int = 32
    # Max packets a single handler invocation may emit before it must yield
    # (schedules K_TX_RESUME at the same timestamp to continue).
    send_burst: int = 4
    # Max inner rounds per window (safety bound; overflow is counted).
    max_rounds: int = 256
    # Sharded engine: per-(src shard → dst shard) all_to_all bucket capacity
    # per window. 0 = auto (2× the uniform-traffic expectation, min 16).
    # Bucket-full drops are counted (x2x_overflow); parity requires 0.
    x2x_cap: int = 0
    # Sparse-window compaction bucket (active-host lanes per window; see
    # core/compact.py). 0 = off. Windows whose active-host count exceeds
    # the bucket run full-width — results are bit-identical either way, so
    # this is purely a perf knob. Size from tools/activeprobe.py (rung3
    # p99 = 284 of 1000; rung4 max = 1082 of 10000).
    compact_cap: int = 0
    # On-device telemetry ring: per-window counter-delta rows kept on
    # device (telemetry/ring.py) and drained at chunk boundaries. Value =
    # ring depth in windows (the horizon of per-window records a chunk can
    # recover); 0 = off — the SimState pytree then carries no ring leaf, so
    # the default is layout-identical to a ring-less build. Size it ≥ the
    # heartbeat chunk to get a gap-free time series (CLI --metrics-ring).
    metrics_ring: int = 0
    # Occupancy-driven capacity autotuning (shadow1_tpu/tune/): 1 = let the
    # chunk runner resize ev_cap between chunks from the measured high-water
    # fill gauges (grow before overflow, shrink after sustained low
    # occupancy; caps quantized to the tune.ladder geometric ladder so the
    # jit cache stays bounded). CLI --auto-caps overrides. outbox_cap is NOT
    # auto-resized by default: it is a semantic knob for TCP (tcp_flush
    # paces on outbox_space), so changing it mid-run changes the event
    # stream — see tune.autocap.CapPolicy.tune_outbox.
    auto_caps: int = 0
    # Flow-probe watchlist (telemetry/probes.py): K (host, sock) pairs whose
    # state columns are sampled once per window into the [W, K, F] probe
    # ring (W = metrics_ring depth). host is a GLOBAL host id; sock == -1
    # means the host-only (NIC/event) view. Resolved from the ``probes:``
    # config section / --watch through config/experiment.resolve_watchlist
    # — NEVER set raw names here; entries must be ints by trace time (they
    # are static jit arguments). () (default) = off: no probe leaf rides
    # SimState and zero probe ops are traced, the --state-digest rule.
    probes: tuple = ()
    # Determinism flight recorder (core/digest.py): 1 = compute per-window
    # order-independent state digests (one word per subsystem: evbuf,
    # outbox, tcp, nic, rng counters) inside the jitted window loop and
    # record them as telemetry-ring columns. Requires metrics_ring > 0 on
    # the batched engines (the ring is where the stream lives); the CPU
    # oracle mirrors the identical words at window boundaries. 0 (default)
    # = off: zero digest ops traced anywhere — the ring columns exist but
    # hold zeros. CLI --state-digest.
    state_digest: int = 0
    # Link-telemetry plane (telemetry/links.py): 1 = carry the [V, V, F]
    # per-edge accumulator in SimState and scatter-add every routed
    # packet's edge contribution at the window-end route phase (plus NIC
    # drop-tail drops at the tx sites), drained at chunk boundaries into
    # JSONL ``link`` records. 0 (default) = off: no link leaf rides
    # SimState and zero link ops are traced — the --state-digest rule.
    # The accumulator is never digested, so 1 is digest-neutral. CLI
    # --link-telem.
    link_telem: int = 0
    # Overflow policy (shadow1_tpu/txn.py; CLI --on-overflow): what the
    # chunk runner does when a chunk's fresh overflow deltas (ev_overflow /
    # ob_overflow / sharded x2x_overflow) are non-zero at its boundary.
    # "drop" (default) keeps today's counted-but-lossy behavior; "retry"
    # discards the tainted chunk, grows the offending cap one ladder step
    # (bit-exact state migration + re-jit) and replays the same chunk from
    # the saved chunk-start state — the retried run's digest stream
    # bit-matches a straight run at the final caps; "halt" raises a
    # structured CapacityExceededError with paste-ready cap advice.
    # Inert on the eager CPU oracle except "halt" (boundary check only).
    on_overflow: str = "drop"
    # Fleet lane-failure policy (fleet/run.py; CLI --on-lane-fail): what a
    # fleet run does when ONE lane deterministically fails at a chunk
    # boundary (capacity halt / retry-ladder exhaustion attributed to the
    # lane, or a per-lane selfcheck violation). "halt" (default) raises —
    # the whole sweep dies with the solo error/exit taxonomy; "quarantine"
    # slices the failing lane out of the chunk-START state into a
    # solo-resumable checkpoint plus a structured fleet_quarantine record,
    # repacks the survivors into an E-1 fleet (re-jit; survivor digest
    # streams provably unchanged — lanes are vmap-independent) and replays
    # the chunk, finishing the sweep at E-k/E. Inert on solo engines.
    on_lane_fail: str = "halt"
    # Mid-sweep lane finalization (fleet/run.py; CLI --lane-finalize):
    # 1 = at committed chunk boundaries, lanes whose event buffer has fully
    # drained (no live event anywhere — nothing can ever fire again) are
    # finalized early: their fleet_exp final record is emitted immediately
    # and they are sliced out of the fleet the quarantine way, so the
    # device program shrinks to the lanes still doing work. 0 (default) =
    # every lane runs the full window count. Inert on solo engines.
    lane_finalize: int = 0
    # In-run self-check (txn.check_boundary_identity; CLI --selfcheck):
    # 1 = verify the drop-accounting identity (every sent packet reaches
    # exactly one counted fate) at every chunk boundary (batched engines)
    # / window boundary (cpu oracle); violation raises SelfCheckError
    # naming the non-closing counters. 0 (default) = off.
    selfcheck: int = 0
    # Pop-min result extraction: "sum" (masked-sum over the one-hot — the
    # round-4 default) or "gather" (index via min-over-iota, then
    # take_along_axis — the round-3 style on the round-4 layout). Bit-exact
    # either way (the one-hot is exact); a perf A/B knob for the round-path
    # regression hunt (docs/PERF.md round-5).
    pop_extract: str = "sum"
    # Pop-min implementation: "xla" (the masked-reduction chain in
    # core/events.py) or "pallas" (the fused single-pass VMEM kernel in
    # core/popk.py — one HBM read/write per plane instead of ~12 full-plane
    # passes). Bit-exact either way (tests/test_events.py); a perf knob
    # pending on-chip A/B (docs/PERF.md round-5).
    pop_impl: str = "xla"
    # Push implementation, same contract: "xla" (first-free + one-hot
    # wheres) or "pallas" (core/popk.py fused single-pass kernel). Scoped
    # into the handler layers at trace time via events.push_impl_ctx.
    push_impl: str = "xla"

    # --- TCP constants (reference: src/main/host/descriptor/tcp.c) ---
    mss: int = 1460               # bytes per segment
    init_cwnd_mss: int = 10       # RFC6928 initial window
    sndbuf: int = 131072          # send buffer bytes
    rcvbuf: int = 131072          # advertised receive window (apps drain fast)
    rto_min: int = 200 * MS
    rto_max: int = 60 * SEC
    rto_init: int = 1 * SEC
    dupack_thresh: int = 3

    def __post_init__(self):
        assert self.sockets_per_host <= 256, "sock ids are packed into 8 bits"
        assert self.pop_extract in ("sum", "gather"), self.pop_extract
        assert self.metrics_ring >= 0, self.metrics_ring
        assert self.state_digest in (0, 1), self.state_digest
        assert self.link_telem in (0, 1), self.link_telem
        assert isinstance(self.probes, tuple), (
            "probes must be a tuple of (host, sock) int pairs "
            "(resolve_watchlist builds it)")
        for pr in self.probes:
            assert (isinstance(pr, tuple) and len(pr) == 2
                    and all(isinstance(v, int) for v in pr)), pr
            assert 0 <= pr[0], pr
            assert -1 <= pr[1] < self.sockets_per_host, pr
        assert self.auto_caps >= 0, self.auto_caps
        assert self.on_overflow in ("drop", "retry", "halt"), self.on_overflow
        assert self.on_lane_fail in ("halt", "quarantine"), self.on_lane_fail
        assert self.lane_finalize in (0, 1), self.lane_finalize
        assert self.selfcheck in (0, 1), self.selfcheck
        assert self.pop_impl in ("xla", "pallas"), self.pop_impl
        assert self.push_impl in ("xla", "pallas"), self.push_impl
        # The fused pop kernel extracts via the one-hot masked sum only; a
        # silent no-op pop_extract would corrupt exactly the A/B this knob
        # exists for.
        assert not (self.pop_impl == "pallas" and self.pop_extract != "sum"), (
            "pop_impl='pallas' implies pop_extract='sum'"
        )


# App notification flags (per-round, host-level — set by the transport layer,
# consumed by the app layer in the same round; the tensor analogue of the
# reference's descriptor status-bit → epoll → plugin callback chain,
# src/main/host/descriptor/descriptor.c + epoll.c, SURVEY §3.4).
N_ESTABLISHED = 1   # client: connect completed
N_ACCEPTED = 2      # server: child socket entered ESTABLISHED
N_MSG = 4           # in-order stream delivery crossed a message boundary
N_SPACE = 8         # send-buffer space became available
N_PEER_FIN = 16     # peer closed its direction
N_CLOSED = 32       # connection fully closed
N_DGRAM = 64        # datagram delivered
N_DATA = 128        # in-order stream bytes delivered (dlen)

# Wire overhead modeled per packet (IP + TCP headers), bytes.
WIRE_OVERHEAD = 40

# --- u32 wrapping sequence-number helpers (Python-int flavour, used by the
# CPU oracle; the TPU engine gets identical semantics from i32 overflow). ---
_M32 = 0xFFFFFFFF


def seq_add(a: int, n: int) -> int:
    return (a + n) & _M32


def seq_sub(a: int, b: int) -> int:
    """Signed distance a-b in sequence space."""
    d = (a - b) & _M32
    return d - (1 << 32) if d >= (1 << 31) else d


def seq_lt(a: int, b: int) -> bool:
    return seq_sub(a, b) < 0


def seq_le(a: int, b: int) -> bool:
    return seq_sub(a, b) <= 0


def ser_delay_ns(wire_bytes: int, bw_bits: int) -> int:
    """Serialization delay of a packet on a link, ns (ceil division)."""
    return (wire_bytes * 8 * SEC + bw_bits - 1) // bw_bits


# TCP connection states (reference tcp.c state machine).
TCP_FREE = 0
TCP_LISTEN = 1
TCP_SYN_SENT = 2
TCP_SYN_RCVD = 3
TCP_ESTABLISHED = 4
TCP_FIN_WAIT_1 = 5
TCP_FIN_WAIT_2 = 6
TCP_CLOSE_WAIT = 7
TCP_LAST_ACK = 8
TCP_CLOSING = 9
TCP_TIME_WAIT = 10
TCP_CLOSED = 11

# Shared TCP tuning constants (single source of truth for both engines).
SSTHRESH_INIT = 1 << 28
CWND_MAX = 1 << 28

# State sets used by both engines' send/receive paths.
TCP_SENDABLE_STATES = (
    TCP_SYN_SENT, TCP_SYN_RCVD, TCP_ESTABLISHED, TCP_CLOSE_WAIT,
    TCP_FIN_WAIT_1, TCP_LAST_ACK, TCP_CLOSING,
)
TCP_CONN_STATES = (
    TCP_SYN_SENT, TCP_SYN_RCVD, TCP_ESTABLISHED, TCP_FIN_WAIT_1,
    TCP_FIN_WAIT_2, TCP_CLOSE_WAIT, TCP_LAST_ACK, TCP_CLOSING,
)
TCP_RCV_STATES = (TCP_ESTABLISHED, TCP_FIN_WAIT_1, TCP_FIN_WAIT_2)

"""The telemetry ring's schema — a copy of the ring part of the JAX
package's ``telemetry/registry.py`` (the port imports nothing of that
package), so a ring row means the same thing to both: its record types and
its columns, in order. Keep the two in step.

Counter columns are per-window DELTAS of the ``Metrics`` counters of the
same name; gauge columns are per-window occupancy gauges; digest columns
are the per-window state-digest words (``core/digest.py``), all 0 when
``state_digest`` is off.
"""

REC_RING = "ring"
REC_RING_GAP = "ring_gap"

RING_COUNTERS = (
    "events", "rounds", "pkts_sent", "pkts_delivered", "pkts_lost",
    "ev_overflow", "ob_overflow", "x2x_overflow", "down_events", "down_pkts",
    "link_down_pkts", "host_restarts",
)
# Wasted-work columns: per-window deltas of the running-sum counters, i.e.
# the window's boundary sample itself.
RING_WORK = (
    "active_hosts",   # hosts with >=1 eligible event at window start
    "elig_events",    # events eligible at window start
    "outbox_hosts",   # hosts that used >=1 outbox slot this window
)
RING_GAUGES = (
    "evbuf_fill",       # max pending events on any host at window end
    "ev_max_fill",      # running high-water of evbuf_fill (vs ev_cap)
    "ob_max_fill",      # running high-water per-window outbox fill
    "compact_max_fill", # running high-water compaction-bucket demand
    "x2x_max_fill",     # running high-water all_to_all bucket demand
)
RING_DIGESTS = ("dg_evbuf", "dg_outbox", "dg_tcp", "dg_nic", "dg_rng")
RING_FIELDS = RING_COUNTERS + RING_WORK + RING_GAUGES + RING_DIGESTS

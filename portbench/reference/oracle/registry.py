"""Record type names and row schemas the oracle's rows carry."""

REC_DIGEST = "digest"
REC_WORK = "work"
REC_FLOW = "flow"
REC_LINK = "link"

# Flow-probe columns, one row per window per watched (host, socket).
PROBE_FIELDS = (
    "tcp_state", "cwnd", "ssthresh", "srtt", "rttvar", "rto", "inflight",
    "snd_max", "peer_wnd", "nic_tx_backlog_ns", "nic_rx_backlog_ns",
    "nic_tx_bytes", "nic_rx_bytes", "pending_events",
)
# Link-telemetry columns, running totals per (src_vertex, dst_vertex).
LINK_FIELDS = (
    "pkts", "bytes", "loss_drops", "link_down_drops", "nic_backlog_drops",
    "queued_ns_sum", "queued_ns_max",
)

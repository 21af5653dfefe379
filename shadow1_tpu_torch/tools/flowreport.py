"""Flow report — render and diagnose the flow-probe stream.

The reference's per-socket Tracker output is what operators actually read
when a transfer misbehaves: cwnd over time, RTO growth, zero-window stalls
(src/main/host/tracker.c, SURVEY §5). This consumes the ``flow`` JSONL
records the probe plane emits (--watch / probes:, telemetry/probes.py;
docs/OBSERVABILITY.md "Flow probe records") and produces:

* per-flow time series — CSV (--csv) and terminal sparklines;
* a STALL DIAGNOSIS per flow: RTO storms, zero-window peer stalls, cwnd
  collapses, NIC backlog saturation and quiescent-but-open flows, each
  with the window range where it happened.

torch-free by design (log analysis must run anywhere), like
heartbeat_report. ``--selftest`` feeds the detectors a synthesized RTO
storm and fails loudly if it is not flagged —
``tests/test_torch_reports.py`` runs it as the observability smoke gate.

    python -m shadow1_tpu_torch.tools.flowreport run.log [--csv flows.csv]
        [--json] [--spark-width 60]
    python -m shadow1_tpu_torch.tools.flowreport --selftest
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

from shadow1_tpu_torch.telemetry.registry import PROBE_FIELDS, REC_FLOW

# TCP states mirrored from consts.py (kept literal so this tool never
# imports the torch-adjacent engine modules by accident).
TCP_ESTABLISHED = 4
DEFAULT_MSS = 1460

# Sparkline glyph ramp (8 levels) — degrades to ASCII with --ascii.
_SPARKS = "▁▂▃▄▅▆▇█"
_ASCII_SPARKS = "_.-=+*#%"


def load_records(path: str) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return recs


def group_flows(recs: list[dict]) -> dict[tuple, list[dict]]:
    """REC_FLOW records → {(exp, host, sock): rows sorted by window}.

    Fleet logs tag rows with ``exp``; solo logs leave it absent (None
    key). Duplicate windows (a resumed run replaying its drained chunk)
    collapse to the LAST occurrence — probe rows are deterministic, so
    replays carry identical values anyway."""
    by_key: dict[tuple, dict[int, dict]] = {}
    for r in recs:
        if r.get("type") != REC_FLOW:
            continue
        key = (r.get("exp"), r.get("host"), r.get("sock"))
        by_key.setdefault(key, {})[r.get("window", 0)] = r
    return {
        k: [w[i] for i in sorted(w)]
        for k, w in sorted(
            by_key.items(),
            key=lambda kv: (kv[0][0] is not None, kv[0][0] or 0,
                            kv[0][1] or 0, kv[0][2] or 0))
    }


def _window_ns(rows: list[dict]) -> int | None:
    """The window length, recovered from one row's (window, sim_time_s)
    pair: sim_time_s = (window + 1) * window_ns / 1e9 exactly."""
    for r in rows:
        w = r.get("window")
        t = r.get("sim_time_s")
        if w is not None and t is not None:
            return round(t * 1e9 / (w + 1))
    return None


# -- stall detectors --------------------------------------------------------
#
# Each detector takes the flow's window-sorted rows and returns a finding
# dict {"kind", "first_window", "last_window", ...detail} or None. They
# key off the PROBE_FIELDS columns only — anything derivable from the
# stream, nothing needing the config.

def detect_rto_storm(rows: list[dict]) -> dict | None:
    """Two or more CONSECUTIVE rto increases while data is in flight —
    the exponential-backoff signature of a flow losing every probe
    (retransmit timer doubling with nothing ACKed)."""
    best = None
    run_start = None
    run = 0
    for prev, cur in zip(rows, rows[1:]):
        grew = (cur.get("rto", 0) > prev.get("rto", 0)
                and cur.get("inflight", 0) > 0)
        if grew:
            if run == 0:
                run_start = prev.get("window")
            run += 1
            if run >= 2 and (best is None or run > best["backoffs"]):
                best = {"kind": "rto_storm",
                        "first_window": run_start,
                        "last_window": cur.get("window"),
                        "backoffs": run,
                        "rto_ns": cur.get("rto")}
        else:
            run = 0
    return best


def detect_zero_window(rows: list[dict]) -> dict | None:
    """peer_wnd == 0 while ESTABLISHED: the receiver closed its window and
    the sender is stalled waiting for a window update."""
    hit = [r for r in rows
           if r.get("tcp_state") == TCP_ESTABLISHED
           and r.get("peer_wnd") == 0]
    if not hit:
        return None
    return {"kind": "zero_window",
            "first_window": hit[0].get("window"),
            "last_window": hit[-1].get("window"),
            "windows": len(hit)}


def detect_cwnd_collapse(rows: list[dict],
                         mss: int = DEFAULT_MSS) -> dict | None:
    """cwnd fell to ≤ peak/4 after a peak of ≥ 4·mss — a loss event (or
    storm) cut the congestion window hard. Slow-start ramps are exempt:
    only the post-peak minimum counts."""
    peak = 0
    peak_w = None
    best = None
    for r in rows:
        c = r.get("cwnd", 0)
        if c > peak:
            peak, peak_w = c, r.get("window")
        elif peak >= 4 * mss and c <= peak // 4:
            if best is None or c < best["cwnd_min"]:
                best = {"kind": "cwnd_collapse",
                        "first_window": peak_w,
                        "last_window": r.get("window"),
                        "cwnd_peak": peak, "cwnd_min": c}
    return best


def detect_nic_backlog(rows: list[dict],
                       window_ns: int | None) -> dict | None:
    """NIC tx backlog beyond ~4 windows of serialization time: the host is
    generating traffic faster than its line rate drains it (the probe
    column is free-time beyond the window end, so > 0 already means the
    NIC is scheduled past the horizon)."""
    if window_ns is None:
        return None
    thresh = 4 * window_ns
    hit = [r for r in rows if r.get("nic_tx_backlog_ns", 0) > thresh]
    if not hit:
        return None
    worst = max(hit, key=lambda r: r.get("nic_tx_backlog_ns", 0))
    return {"kind": "nic_backlog_saturation",
            "first_window": hit[0].get("window"),
            "last_window": hit[-1].get("window"),
            "backlog_ns_max": worst.get("nic_tx_backlog_ns"),
            "threshold_ns": thresh}


def detect_quiescent(rows: list[dict], trailing: int = 4) -> dict | None:
    """ESTABLISHED with nothing in flight and no new data sent (snd_max
    frozen) over the trailing ``trailing`` windows — an open flow that
    has gone silent (app idle, or the peer's zero window outlived the
    capture)."""
    if len(rows) < trailing:
        return None
    tail = rows[-trailing:]
    if all(r.get("tcp_state") == TCP_ESTABLISHED
           and r.get("inflight", 1) == 0
           and r.get("snd_max") == tail[0].get("snd_max")
           for r in tail):
        return {"kind": "quiescent",
                "first_window": tail[0].get("window"),
                "last_window": tail[-1].get("window"),
                "windows": trailing}
    return None


def diagnose_flow(rows: list[dict], window_ns: int | None = None,
                  mss: int = DEFAULT_MSS) -> list[dict]:
    """All stall findings for one flow's window-sorted rows."""
    if window_ns is None:
        window_ns = _window_ns(rows)
    findings = [
        detect_rto_storm(rows),
        detect_zero_window(rows),
        detect_cwnd_collapse(rows, mss=mss),
        detect_nic_backlog(rows, window_ns),
        detect_quiescent(rows),
    ]
    return [f for f in findings if f is not None]


# -- rendering --------------------------------------------------------------

def sparkline(values: list, width: int = 60, ascii_only: bool = False) -> str:
    """Downsample ``values`` to ``width`` buckets (bucket max — spikes must
    survive) and render one glyph per bucket."""
    if not values:
        return ""
    ramp = _ASCII_SPARKS if ascii_only else _SPARKS
    if len(values) > width:
        n = len(values)
        values = [max(values[i * n // width:
                             max(i * n // width + 1, (i + 1) * n // width)])
                  for i in range(width)]
    lo, hi = min(values), max(values)
    span = hi - lo
    if span == 0:
        return ramp[0] * len(values)
    return "".join(ramp[int((v - lo) * (len(ramp) - 1) / span)]
                   for v in values)


def _flow_label(key: tuple) -> str:
    exp, host, sock = key
    tag = f"exp {exp} " if exp is not None else ""
    ent = f"host {host}" if (sock is None or sock < 0) else \
        f"host {host} sock {sock}"
    return tag + ent


def flow_stats(rows: list[dict]) -> dict:
    """Compact per-flow stats for the report header / heartbeat_report's
    flows section."""
    last = rows[-1]
    inflight = [r.get("inflight", 0) for r in rows]
    return {
        "windows": len(rows),
        "first_window": rows[0].get("window"),
        "last_window": last.get("window"),
        "tcp_state_last": last.get("tcp_state"),
        "cwnd_last": last.get("cwnd"),
        "srtt_last_ns": last.get("srtt"),
        "rto_last_ns": last.get("rto"),
        "inflight_max": max(inflight) if inflight else 0,
        "peer_wnd_min": min((r.get("peer_wnd", 0) for r in rows),
                            default=0),
        "nic_tx_backlog_ns_max": max(
            (r.get("nic_tx_backlog_ns", 0) for r in rows), default=0),
        "pending_events_last": last.get("pending_events"),
    }


def report(flows: dict[tuple, list[dict]], out=None, width: int = 60,
           ascii_only: bool = False, mss: int = DEFAULT_MSS) -> dict:
    out = out if out is not None else sys.stdout
    result: dict = {"flows": {}}
    for key, rows in flows.items():
        label = _flow_label(key)
        stats = flow_stats(rows)
        findings = diagnose_flow(rows, mss=mss)
        result["flows"][label] = {**stats, "stalls": findings}
        print(f"== flow: {label} ==", file=out)
        print(f"  windows {stats['windows']} "
              f"[{stats['first_window']}..{stats['last_window']}]  "
              f"state {stats['tcp_state_last']}  "
              f"cwnd {stats['cwnd_last']}  "
              f"srtt {stats['srtt_last_ns']} ns  "
              f"rto {stats['rto_last_ns']} ns", file=out)
        for field in ("cwnd", "inflight", "srtt",
                      "nic_tx_backlog_ns", "pending_events"):
            series = [r.get(field, 0) for r in rows]
            if not any(series):
                continue
            print(f"  {field:>18} "
                  f"{sparkline(series, width, ascii_only)}  "
                  f"max {max(series)}", file=out)
        if findings:
            for f in findings:
                detail = {k: v for k, v in f.items()
                          if k not in ("kind", "first_window",
                                       "last_window")}
                print(f"  STALL {f['kind']}: windows "
                      f"{f['first_window']}..{f['last_window']}  "
                      f"{detail}", file=out)
        else:
            print("  no stalls detected", file=out)
    return result


def write_csv(flows: dict[tuple, list[dict]], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["exp", "host", "sock", "window", "sim_time_s",
                    *PROBE_FIELDS])
        for (exp, host, sock), rows in flows.items():
            for r in rows:
                w.writerow([exp, host, sock, r.get("window"),
                            r.get("sim_time_s"),
                            *[r.get(field) for field in PROBE_FIELDS]])


# -- self-test --------------------------------------------------------------

def _synth_rto_storm() -> list[dict]:
    """A synthesized flow: clean slow-start, then every window doubles the
    RTO with a full segment stuck in flight — the detector MUST flag it."""
    window_ns = 1_000_000
    rows = []
    rto = 250_000_000
    for w in range(20):
        cwnd = min(14600 * (w + 1), 64 * 1460)
        inflight = 1460
        if w >= 10:  # storm: nothing ACKs, the timer doubles per window
            rto *= 2
        rows.append({
            "type": REC_FLOW, "window": w,
            "sim_time_s": round((w + 1) * window_ns / 1e9, 9),
            "host": 0, "sock": 0,
            "tcp_state": TCP_ESTABLISHED, "cwnd": cwnd,
            "ssthresh": 1 << 28, "srtt": 2_000_000, "rttvar": 500_000,
            "rto": rto, "inflight": inflight, "snd_max": 1460 * (w + 1),
            "peer_wnd": 65535, "nic_tx_backlog_ns": 0,
            "nic_rx_backlog_ns": 0, "nic_tx_bytes": 1460 * (w + 1),
            "nic_rx_bytes": 0, "pending_events": 2,
        })
    return rows


def selftest(out=None) -> int:
    """Detector smoke: the injected RTO storm must be flagged, and a clean
    ramp must NOT be (the observability gate)."""
    out = out if out is not None else sys.stdout
    rows = _synth_rto_storm()
    findings = diagnose_flow(rows)
    kinds = {f["kind"] for f in findings}
    clean = diagnose_flow(rows[:10])  # pre-storm prefix: healthy ramp
    ok = "rto_storm" in kinds and not any(
        f["kind"] == "rto_storm" for f in clean)
    print(json.dumps({"selftest": "ok" if ok else "FAIL",
                      "storm_flagged": sorted(kinds),
                      "clean_prefix_flagged": sorted(
                          f["kind"] for f in clean)}), file=out)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.flowreport")
    ap.add_argument("log", nargs="?",
                    help="JSONL log carrying 'flow' records "
                         "(CLI --watch stderr, or a heartbeat log)")
    ap.add_argument("--csv", default=None,
                    help="write the per-flow time series as CSV")
    ap.add_argument("--json", action="store_true",
                    help="print the stats+stalls result as JSON instead "
                         "of the terminal report")
    ap.add_argument("--spark-width", type=int, default=60, metavar="N",
                    help="sparkline width in glyphs (default 60)")
    ap.add_argument("--ascii", action="store_true",
                    help="ASCII sparklines (no Unicode blocks)")
    ap.add_argument("--mss", type=int, default=DEFAULT_MSS,
                    help="segment size for the cwnd-collapse threshold "
                         f"(default {DEFAULT_MSS})")
    ap.add_argument("--selftest", action="store_true",
                    help="run the stall-detector self-test and exit")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.log:
        ap.error("a log path is required (or --selftest)")
    recs = load_records(args.log)
    flows = group_flows(recs)
    if not flows:
        print("no 'flow' records found — run with --watch or a config "
              "'probes:' section", file=sys.stderr)
        return 1
    if args.json:
        result = {"flows": {}}
        for key, rows in flows.items():
            result["flows"][_flow_label(key)] = {
                **flow_stats(rows),
                "stalls": diagnose_flow(rows, mss=args.mss)}
        print(json.dumps(result, indent=2))
    else:
        report(flows, width=args.spark_width, ascii_only=args.ascii,
               mss=args.mss)
    if args.csv:
        write_csv(flows, args.csv)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

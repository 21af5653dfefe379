"""Network report — render and diagnose the link-telemetry stream as a
topology weathermap.

The reference's per-link capture (interface counters + pcap hooks,
src/main/routing/) is what operators read when the NETWORK — not a flow —
misbehaves: which edge is hot, which edge is losing, where drops
concentrate. This consumes the ``link`` JSONL records the link plane emits
(--link-telem on, telemetry/links.py; docs/OBSERVABILITY.md "Link
records") and produces:

* a per-edge table — offered packets/bytes, loss / outage / NIC-backlog
  drops, mean and max queued latency, sorted hottest-first;
* a V×V byte heatmap (terminal glyphs or --heatmap csv);
* the hottest path: a greedy max-byte walk across the edge graph;
* a DIAGNOSIS: loss concentration, persistent egress saturation,
  dark links (offered traffic 100% outage-dropped), elephant-edge skew
  — each naming the edges and the evidence.

Link records are CUMULATIVE snapshots (running totals per drain
boundary), so totals come from each edge's last row and rates from
consecutive-row deltas; a ``link_gap`` row marks a counter rebase (fleet
lane rebind) and resets the delta baseline.

torch-free by design (log analysis must run anywhere), like flowreport.
``--selftest`` feeds the detectors synthesized pathologies and fails
loudly if any is missed — ``tests/test_torch_reports.py`` runs it as
the network observability smoke gate.

    python -m shadow1_tpu_torch.tools.netreport run.log [--csv edges.csv]
        [--json] [--heatmap ascii|csv|off] [--top N]
    python -m shadow1_tpu_torch.tools.netreport --selftest
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

from shadow1_tpu_torch.telemetry.registry import (
    LINK_FIELDS,
    REC_LINK,
    REC_LINK_GAP,
)

# Heatmap glyph ramp (log-scaled) — degrades to ASCII with --ascii.
_SHADES = " ░▒▓█"
_ASCII_SHADES = " .:*#"

# Egress saturation threshold: queued latency beyond this many windows of
# runahead means the NIC schedule spills far past the horizon.
SATURATION_WINDOWS = 4

# Elephant skew: the top edge carries ≥ this multiple of the median
# nonzero edge AND ≥ this fraction of all bytes.
ELEPHANT_RATIO = 10
ELEPHANT_SHARE = 0.25

# Loss concentration: one edge holds ≥ this fraction of all loss drops
# while at least one other edge also carries traffic.
LOSS_SHARE = 0.5


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


def group_edges(recs: list[dict]) -> dict[tuple, list[dict]]:
    """REC_LINK records → {(exp, src, dst): rows sorted by window}.

    Fleet logs tag rows with ``exp``; solo logs leave it absent (None
    key). Duplicate windows (a resumed run replaying a drained boundary)
    collapse to the LAST occurrence — snapshots are cumulative and
    deterministic, so replays carry identical values anyway."""
    by_key: dict[tuple, dict[int, dict]] = {}
    for r in recs:
        if r.get("type") != REC_LINK:
            continue
        key = (r.get("exp"), r.get("src_vertex"), r.get("dst_vertex"))
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
    pair: sim_time_s = (window + 1) * window_ns / 1e9 exactly (the same
    drain convention every plane shares)."""
    for r in rows:
        w = r.get("window")
        t = r.get("sim_time_s")
        if w is not None and t is not None:
            return round(t * 1e9 / (w + 1))
    return None


def edge_deltas(rows: list[dict]) -> list[dict]:
    """Per-boundary counter deltas from one edge's cumulative snapshots.

    A counter running BACKWARD between consecutive rows marks a rebase
    (fleet lane rebind emitted a link_gap; the fresh lane restarted its
    totals) — the later row then IS the delta since its own start."""
    out = []
    prev = None
    for r in rows:
        if prev is not None and r.get("pkts", 0) >= prev.get("pkts", 0):
            d = {f: r.get(f, 0) - prev.get(f, 0) for f in LINK_FIELDS}
        else:
            d = {f: r.get(f, 0) for f in LINK_FIELDS}
        # queued_ns_max is a high-water gauge, never a rate — carry the
        # snapshot value through.
        d["queued_ns_max"] = r.get("queued_ns_max", 0)
        d["window"] = r.get("window")
        out.append(d)
        prev = r
    return out


def edge_totals(edges: dict[tuple, list[dict]]) -> dict[tuple, dict]:
    """{edge key: final cumulative counters + derived fields}."""
    out = {}
    for key, rows in edges.items():
        last = rows[-1]
        t = {f: last.get(f, 0) for f in LINK_FIELDS}
        drops = (t["loss_drops"] + t["link_down_drops"]
                 + t["nic_backlog_drops"])
        t["drops"] = drops
        t["queued_ns_avg"] = (t["queued_ns_sum"] // t["pkts"]
                              if t["pkts"] else 0)
        t["last_window"] = last.get("window")
        out[key] = t
    return out


# -- diagnosis --------------------------------------------------------------
#
# Each detector takes the grouped edge streams (plus totals) and returns a
# finding dict {"kind", "edges", ...detail} or None. They key off the
# LINK_FIELDS columns only — anything derivable from the stream, nothing
# needing the config.

def _fmt_edge(key: tuple) -> str:
    exp, src, dst = key
    tag = f"exp {exp} " if exp is not None else ""
    return f"{tag}{src}->{dst}"


def detect_loss_concentration(totals: dict[tuple, dict]) -> dict | None:
    """One edge holds the majority of all random-loss drops while other
    edges also carry traffic — the loss is topological (one bad link),
    not ambient."""
    total_loss = sum(t["loss_drops"] for t in totals.values())
    if total_loss == 0:
        return None
    top_key, top = max(totals.items(), key=lambda kv: kv[1]["loss_drops"])
    others_carry = any(t["pkts"] > 0 for k, t in totals.items()
                      if k != top_key)
    share = top["loss_drops"] / total_loss
    if share >= LOSS_SHARE and others_carry:
        return {"kind": "loss_concentration",
                "edges": [_fmt_edge(top_key)],
                "loss_drops": top["loss_drops"],
                "share": round(share, 3)}
    return None


def detect_egress_saturation(edges: dict[tuple, list[dict]],
                             window_ns: int | None) -> dict | None:
    """An edge whose max queued latency exceeds SATURATION_WINDOWS windows
    of runahead: its egress NIC is scheduled far past the horizon — the
    host behind it is offering more than the line rate drains."""
    if not window_ns:
        return None
    thresh = SATURATION_WINDOWS * window_ns
    hit = []
    for key, rows in edges.items():
        worst = max((r.get("queued_ns_max", 0) for r in rows), default=0)
        if worst > thresh:
            hit.append((key, worst))
    if not hit:
        return None
    hit.sort(key=lambda kw: -kw[1])
    return {"kind": "egress_saturation",
            "edges": [_fmt_edge(k) for k, _ in hit],
            "queued_ns_max": hit[0][1],
            "threshold_ns": thresh}


def detect_dark_links(edges: dict[tuple, list[dict]]) -> dict | None:
    """An edge where, over some snapshot interval, EVERY offered packet
    was dropped by a link outage (fault plane link_down) — the link went
    fully dark while traffic kept arriving."""
    dark = []
    for key, rows in edges.items():
        for d in edge_deltas(rows):
            if d["pkts"] > 0 and d["link_down_drops"] >= d["pkts"]:
                dark.append((key, d["window"], d["link_down_drops"]))
                break
    if not dark:
        return None
    return {"kind": "dark_link",
            "edges": [_fmt_edge(k) for k, _, _ in dark],
            "first_window": min(w for _, w, _ in dark),
            "link_down_drops": sum(n for _, _, n in dark)}


def detect_elephant_skew(totals: dict[tuple, dict]) -> dict | None:
    """The hottest edge carries an outsized share of all bytes relative to
    the median busy edge — one flow (or one aggregation point) dominates
    the fabric."""
    busy = sorted(t["bytes"] for t in totals.values() if t["bytes"] > 0)
    if len(busy) < 2:
        return None
    median = busy[len(busy) // 2]
    top_key, top = max(totals.items(), key=lambda kv: kv[1]["bytes"])
    total = sum(busy)
    if (median > 0 and top["bytes"] >= ELEPHANT_RATIO * median
            and top["bytes"] >= ELEPHANT_SHARE * total):
        return {"kind": "elephant_edge",
                "edges": [_fmt_edge(top_key)],
                "bytes": top["bytes"],
                "median_bytes": median,
                "share": round(top["bytes"] / total, 3)}
    return None


def diagnose_links(edges: dict[tuple, list[dict]],
                   window_ns: int | None = None) -> list[dict]:
    """All network findings for the grouped edge streams."""
    if window_ns is None:
        window_ns = next((w for w in
                          (_window_ns(rows) for rows in edges.values())
                          if w), None)
    totals = edge_totals(edges)
    findings = [
        detect_loss_concentration(totals),
        detect_egress_saturation(edges, window_ns),
        detect_dark_links(edges),
        detect_elephant_skew(totals),
    ]
    return [f for f in findings if f is not None]


def hottest_path(totals: dict[tuple, dict],
                 max_hops: int = 16) -> list[tuple]:
    """Greedy max-byte walk: start at the hottest edge, repeatedly follow
    the heaviest out-edge of the current head, stop on a revisit or a
    dead end. The spine elephant traffic rides through the topology."""
    if not totals:
        return []
    start_key = max(totals, key=lambda k: totals[k]["bytes"])
    if totals[start_key]["bytes"] == 0:
        return []
    exp = start_key[0]
    path = [start_key]
    seen = {start_key[1], start_key[2]}
    head = start_key[2]
    for _ in range(max_hops):
        nxt = [(k, t) for k, t in totals.items()
               if k[0] == exp and k[1] == head and t["bytes"] > 0]
        if not nxt:
            break
        k, _t = max(nxt, key=lambda kt: kt[1]["bytes"])
        if k[2] in seen:
            break
        path.append(k)
        seen.add(k[2])
        head = k[2]
    return path


# -- rendering --------------------------------------------------------------

def _shade(v: int, hi: int, ramp: str) -> str:
    if v <= 0 or hi <= 0:
        return ramp[0]
    import math

    frac = math.log1p(v) / math.log1p(hi)
    return ramp[min(int(frac * (len(ramp) - 1)) + (1 if v else 0),
                    len(ramp) - 1)]


def heatmap_lines(totals: dict[tuple, dict],
                  ascii_only: bool = False) -> list[str]:
    """V×V byte grid, one glyph per directed edge (log-scaled)."""
    verts = sorted({k[1] for k in totals} | {k[2] for k in totals},
                   key=lambda v: (isinstance(v, str), v))
    if not verts:
        return []
    ramp = _ASCII_SHADES if ascii_only else _SHADES
    hi = max((t["bytes"] for t in totals.values()), default=0)
    by_sd: dict[tuple, int] = {}
    for (_e, s, d), t in totals.items():
        by_sd[(s, d)] = by_sd.get((s, d), 0) + t["bytes"]
    wid = max(len(str(v)) for v in verts)
    lines = [" " * (wid + 2)
             + " ".join(f"{str(v)[-1]}" for v in verts)
             + "   (dst; bytes, log shade)"]
    for s in verts:
        row = " ".join(_shade(by_sd.get((s, d), 0), hi, ramp)
                       for d in verts)
        lines.append(f"{str(s):>{wid}}  {row}")
    return lines


def write_heatmap_csv(totals: dict[tuple, dict], out) -> None:
    verts = sorted({k[1] for k in totals} | {k[2] for k in totals},
                   key=lambda v: (isinstance(v, str), v))
    by_sd: dict[tuple, int] = {}
    for (_e, s, d), t in totals.items():
        by_sd[(s, d)] = by_sd.get((s, d), 0) + t["bytes"]
    w = csv.writer(out)
    w.writerow(["src\\dst", *verts])
    for s in verts:
        w.writerow([s, *[by_sd.get((s, d), 0) for d in verts]])


def report(edges: dict[tuple, list[dict]], out=None, top: int = 20,
           heatmap: str = "ascii", ascii_only: bool = False) -> dict:
    out = out if out is not None else sys.stdout
    totals = edge_totals(edges)
    findings = diagnose_links(edges)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1]["bytes"])
    print(f"== link weathermap: {len(totals)} active edges ==", file=out)
    hdr = (f"{'edge':>16} {'pkts':>10} {'bytes':>12} {'loss':>8} "
           f"{'down':>8} {'nic':>8} {'q_avg_ns':>10} {'q_max_ns':>10}")
    print(hdr, file=out)
    for key, t in ranked[:top]:
        print(f"{_fmt_edge(key):>16} {t['pkts']:>10} {t['bytes']:>12} "
              f"{t['loss_drops']:>8} {t['link_down_drops']:>8} "
              f"{t['nic_backlog_drops']:>8} {t['queued_ns_avg']:>10} "
              f"{t['queued_ns_max']:>10}", file=out)
    if len(ranked) > top:
        print(f"  ... {len(ranked) - top} more edges (--top)", file=out)
    if heatmap == "ascii":
        print("", file=out)
        for line in heatmap_lines(totals, ascii_only):
            print("  " + line, file=out)
    path = hottest_path(totals)
    if path:
        verts = [str(path[0][1])] + [str(k[2]) for k in path]
        print(f"\n  hottest path: {' -> '.join(verts)}  "
              f"({sum(totals[k]['bytes'] for k in path)} bytes)", file=out)
    print("", file=out)
    if findings:
        for f in findings:
            detail = {k: v for k, v in f.items()
                      if k not in ("kind", "edges")}
            print(f"  VERDICT {f['kind']}: {', '.join(f['edges'])}  "
                  f"{detail}", file=out)
    else:
        print("  no network pathologies detected", file=out)
    return {"edges": {_fmt_edge(k): t for k, t in ranked},
            "verdicts": findings}


def write_csv(edges: dict[tuple, list[dict]], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["exp", "src_vertex", "dst_vertex", "window",
                    "sim_time_s", *LINK_FIELDS])
        for (exp, s, d), rows in edges.items():
            for r in rows:
                w.writerow([exp, s, d, r.get("window"),
                            r.get("sim_time_s"),
                            *[r.get(field) for field in LINK_FIELDS]])


# -- self-test --------------------------------------------------------------

def _synth_row(w, s, d, window_ns=1_000_000, **kw) -> dict:
    base = {f: 0 for f in LINK_FIELDS}
    base.update({"type": REC_LINK, "window": w,
                 "sim_time_s": round((w + 1) * window_ns / 1e9, 9),
                 "src_vertex": s, "dst_vertex": d})
    base.update(kw)
    return base


def _synth_pathologies() -> list[dict]:
    """Cumulative snapshots carrying all four pathologies: edge 0->1 is an
    elephant with concentrated loss, edge 1->2 goes fully dark mid-run,
    edge 2->3 saturates its egress queue. Edges 0->2 / 3->0 are healthy
    background so the concentration/skew detectors have contrast."""
    recs = []
    for i, w in enumerate((9, 19), start=1):
        recs.append(_synth_row(w, 0, 1, pkts=5000 * i, bytes=7_500_000 * i,
                               loss_drops=400 * i, queued_ns_sum=5000 * i,
                               queued_ns_max=2000))
        # Dark from the second interval: pkts advance, every one dropped.
        recs.append(_synth_row(w, 1, 2, pkts=100 * i, bytes=150_000,
                               link_down_drops=0 if i == 1 else 100,
                               queued_ns_max=1000))
        recs.append(_synth_row(w, 2, 3, pkts=200 * i, bytes=300_000 * i,
                               queued_ns_sum=900_000_000 * i,
                               queued_ns_max=9_000_000))
        recs.append(_synth_row(w, 0, 2, pkts=300 * i, bytes=450_000 * i,
                               loss_drops=10 * i, queued_ns_max=1500))
        recs.append(_synth_row(w, 3, 0, pkts=280 * i, bytes=420_000 * i,
                               queued_ns_max=1200))
    return recs


def _synth_clean() -> list[dict]:
    """Uniform healthy traffic: no drops, shallow queues, even load — no
    detector may fire."""
    recs = []
    for i, w in enumerate((9, 19), start=1):
        for s, d in ((0, 1), (1, 2), (2, 3), (3, 0)):
            recs.append(_synth_row(w, s, d, pkts=1000 * i,
                                   bytes=1_500_000 * i,
                                   queued_ns_sum=10_000 * i,
                                   queued_ns_max=1000))
    return recs


def selftest(out=None) -> int:
    """Detector smoke: every injected pathology must be flagged, and the
    clean fabric must flag NOTHING (the network observability gate)."""
    out = out if out is not None else sys.stdout
    bad = diagnose_links(group_edges(_synth_pathologies()))
    kinds = {f["kind"] for f in bad}
    want = {"loss_concentration", "egress_saturation", "dark_link",
            "elephant_edge"}
    clean = diagnose_links(group_edges(_synth_clean()))
    ok = kinds == want and not clean
    print(json.dumps({"selftest": "ok" if ok else "FAIL",
                      "pathologies_flagged": sorted(kinds),
                      "clean_flagged": sorted(f["kind"] for f in clean)}),
          file=out)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.netreport")
    ap.add_argument("log", nargs="?",
                    help="JSONL log carrying 'link' records "
                         "(CLI --link-telem on stderr, or a heartbeat "
                         "log)")
    ap.add_argument("--csv", default=None,
                    help="write the per-edge snapshot series as CSV")
    ap.add_argument("--json", action="store_true",
                    help="print the edge totals + verdicts as JSON "
                         "instead of the terminal report")
    ap.add_argument("--heatmap", choices=["ascii", "csv", "off"],
                    default="ascii",
                    help="V x V byte heatmap style (csv writes to stdout)")
    ap.add_argument("--top", type=int, default=20, metavar="N",
                    help="edge-table row limit (default 20)")
    ap.add_argument("--ascii", action="store_true",
                    help="ASCII heatmap shades (no Unicode blocks)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the network-detector self-test and exit")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.log:
        ap.error("a log path is required (or --selftest)")
    recs = load_records(args.log)
    edges = group_edges(recs)
    if not edges:
        print("no 'link' records found — run with --link-telem on",
              file=sys.stderr)
        return 1
    gaps = sum(1 for r in recs if r.get("type") == REC_LINK_GAP)
    if gaps:
        print(f"note: {gaps} link_gap rebase marker(s) — counters "
              f"restarted mid-stream (fleet lane rebind)",
              file=sys.stderr)
    if args.json:
        totals = edge_totals(edges)
        print(json.dumps(
            {"edges": {_fmt_edge(k): t for k, t in sorted(
                totals.items(), key=lambda kv: -kv[1]["bytes"])},
             "verdicts": diagnose_links(edges)}, indent=2))
    elif args.heatmap == "csv":
        write_heatmap_csv(edge_totals(edges), sys.stdout)
    else:
        report(edges, top=args.top, heatmap=args.heatmap,
               ascii_only=args.ascii)
    if args.csv:
        write_csv(edges, args.csv)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

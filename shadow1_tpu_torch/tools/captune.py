"""Offline capacity tuner — measured occupancy → recommended `engine:` caps.

    python -m shadow1_tpu_torch.tools.captune run.log [more logs/records ...]
        [--headroom 1.5] [--json]

Reads any mix of the run records the framework emits and distills the
measured peak occupancy of every bounded structure:

* telemetry-ring JSONL (``type: "ring"`` — CLI ``--metrics-ring``, stderr):
  per-window ``evbuf_fill`` plus the running ``*_max_fill`` gauges;
* heartbeat JSONL (``type: "heartbeat"``): the ``fill`` block with the caps
  it was measured against;
* the CLI's final stdout JSON (``{"metrics": ..., "caps": ...}``);
* ``tools/occprobe.py`` audit rows (``boundary_peak_occupancy``/``ev_cap``).

It then prints, per knob, the measured peak, the configured cap (when the
records carry it), the verdict (grow / shrink / ok — tune/ladder.classify),
and a paste-ready config-YAML ``engine:`` block whose provenance comments
follow the ``dense_tgen50k.yaml`` convention — so every rung config can
carry its measurement. Plane-pass economics: every pop/push/clear is a full
``[cap, H]`` pass, so a cap cut is an almost-proportional cut of the whole
round path (docs/PERF.md "cap economics"); the projected saving printed is
``1 − new/old`` of the plane height.

All peaks here are window-end / boundary samples — LOWER bounds on the true
mid-window peak. Recommendations carry ladder-quantized ×1.5 headroom, and
a cap change only counts as validated after an overflow-free full run
(``ev_overflow`` is the authoritative guard; `occprobe` says the same).

Deliberately torch-free (importable by report tools without an accelerator
runtime).
"""

from __future__ import annotations

import argparse
import json
import sys

from shadow1_tpu_torch.tune.ladder import HEADROOM, classify, recommend_cap

# knob → (peak sources, cap key) in priority order. ``evbuf_fill`` (the
# per-window series) and ``ev_max_fill`` (its running max) measure the same
# quantity; max() over everything seen is the run peak either way.
_KNOBS = {
    "ev_cap": ("ev_max_fill", "evbuf_fill", "boundary_peak_occupancy"),
    "outbox_cap": ("ob_max_fill",),
    "compact_cap": ("compact_max_fill",),
    "x2x_cap": ("x2x_max_fill",),
}


def load_records(paths: list[str]) -> list[dict]:
    recs: list[dict] = []
    for path in paths:
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


def group_records(recs: list[dict]) -> dict[str, list[dict]]:
    """Partition records by the config they measured (occprobe rows carry
    ``config``; a single run's ring/heartbeat/final records do not and land
    in one shared group) — peaks must never aggregate across configs.

    Fleet records (ring rows / ``fleet_exp`` finals with an ``exp``
    experiment id) further partition per experiment: a sweep's cap
    verdicts come out one per experiment, and one lane's occupancy can
    never inflate another's recommendation. The experiment id is purely a
    grouping key — it enters no peak/percentile math. Records WITHOUT an
    ``exp`` field from a fleet log (the aggregate heartbeat /
    ``fleet_summary``) land in the shared base group, whose gauges are
    fleet maxima — per-experiment truth stays in the exp groups."""
    groups: dict[str, list[dict]] = {}
    for r in recs:
        key = str(r.get("config", "(run)"))
        if isinstance(r.get("exp"), int):
            key += f" [exp {r['exp']}]"
        groups.setdefault(key, []).append(r)
    return groups


def peaks_from_records(recs: list[dict]) -> tuple[dict, dict, dict]:
    """→ (peaks, caps, overflow): measured peak fill, configured cap and
    summed overflow counters per knob, from whatever record shapes appear."""
    peaks: dict[str, int] = {}
    caps: dict[str, int] = {}
    # Overflow arrives in three redundant shapes — per-window ring deltas,
    # per-chunk heartbeat deltas (which the ring rows sum to), and the
    # cumulative counters of metrics/occprobe records. Accumulate each
    # channel separately and take the max, so any one of them suffices and
    # their redundancy never double-counts into a bogus total.
    _CTRS = (("ev_overflow", "ev_cap"), ("ob_overflow", "outbox_cap"),
             ("x2x_overflow", "x2x_cap"))
    ring_sum = {k: 0 for _, k in _CTRS}
    hb_sum = {k: 0 for _, k in _CTRS}
    cum_max = {k: 0 for _, k in _CTRS}

    def bump(knob, v):
        if v is not None and int(v) > peaks.get(knob, 0):
            peaks[knob] = int(v)

    for r in recs:
        flat = dict(r)
        # Nested shapes: CLI final record / heartbeat fill block.
        for sub in ("metrics", "fill", "caps"):
            if isinstance(r.get(sub), dict):
                flat.update(r[sub])
        for knob, fields in _KNOBS.items():
            for f in fields:
                bump(knob, flat.get(f))
            if isinstance(flat.get(knob), (int, float)) and flat[knob]:
                caps[knob] = int(flat[knob])
        delta = r.get("delta") if isinstance(r.get("delta"), dict) else {}
        if isinstance(r.get("drops"), dict):
            # Heartbeats group the drop counters under a structured block
            # (telemetry.registry.DROP_FIELDS) — same chunk deltas.
            delta = {**delta, **r["drops"]}
        for ctr, knob in _CTRS:
            if r.get("type") == "ring" and isinstance(r.get(ctr), (int, float)):
                ring_sum[knob] += int(r[ctr])
            elif isinstance(delta.get(ctr), (int, float)):
                hb_sum[knob] += int(delta[ctr])
            elif isinstance(flat.get(ctr), (int, float)):
                cum_max[knob] = max(cum_max[knob], int(flat[ctr]))
    overflow = {k: max(ring_sum[k], hb_sum[k], cum_max[k])
                for _, k in _CTRS}
    return peaks, caps, overflow


def advise(peaks: dict, caps: dict, overflow: dict | None = None,
           headroom: float = HEADROOM) -> list[dict]:
    """One advisory row per knob with measured data."""
    out = []
    overflow = overflow or {}
    for knob in _KNOBS:
        peak = peaks.get(knob)
        if not peak:
            continue
        cap = caps.get(knob)
        row = {"knob": knob, "peak": peak, "cap": cap,
               "overflowed": bool(overflow.get(knob))}
        if (knob == "outbox_cap" and cap and peak >= cap
                and not row["overflowed"]):
            # A full outbox with ob_overflow == 0 is TCP send pacing (the
            # flush defers on outbox_space by design), not imminent loss —
            # and outbox_cap is a SEMANTIC knob for TCP (changing it changes
            # the event stream), so never advise a resize from fill alone.
            row.update({"verdict": "pacing", "recommended": cap,
                        "over_factor": 1.0, "target": cap})
        elif cap:
            row.update(classify(peak, cap, headroom))
            if row["verdict"] == "shrink":
                # Plane-pass cost ∝ cap: the projected round-path saving.
                row["plane_pass_saving"] = round(1 - row["recommended"] / cap, 2)
        else:
            row["verdict"] = "measure"
            row["recommended"] = recommend_cap(peak, headroom)
        out.append(row)
    return out


def advise_lines(rows: list[dict]) -> list[str]:
    """Human-readable one-liners (shared with tools/heartbeat_report.py)."""
    lines = []
    for r in rows:
        bits = [f"{r['knob']}: measured peak {r['peak']}"]
        if r.get("cap"):
            bits.append(f"cap {r['cap']} ({r['over_factor']}x peak)")
        if r["verdict"] == "shrink":
            bits.append(f"SHRINK -> {r['recommended']} "
                        f"(~{int(r['plane_pass_saving'] * 100)}% plane-pass cut)")
        elif r["verdict"] == "grow":
            bits.append(f"GROW -> {r['recommended']} (overflow risk)")
        elif r["verdict"] == "pacing":
            bits.append("full at cap with 0 drops — TCP send pacing "
                        "(semantic knob); resizing changes the event stream")
        elif r["verdict"] == "measure":
            bits.append(f"recommend {r['recommended']} (no configured cap seen)")
        else:
            bits.append("ok")
        if r.get("overflowed"):
            bits.append("[RUN OVERFLOWED — peak is a floor, not a peak]")
        lines.append(", ".join(bits))
    return lines


def render_yaml(rows: list[dict], headroom: float = HEADROOM) -> str:
    """Paste-ready ``engine:`` block with measured-peak provenance comments
    (the dense_tgen50k.yaml convention)."""
    if not rows:
        return ""
    lines = ["engine:"]
    for r in rows:
        if r["verdict"] == "pacing":
            lines.append(
                f"  {r['knob']}: {r['cap']}  # captune: full at cap with 0 "
                f"drops = TCP send pacing; semantic knob — keep"
            )
        elif r["verdict"] == "ok":
            lines.append(
                f"  {r['knob']}: {r['cap']}  # captune: measured peak "
                f"{r['peak']} (window-end sample), cap already within the "
                f"x{headroom} headroom band — keep"
            )
        else:
            was = (f"; was {r['cap']} ({r['over_factor']}x over peak)"
                   if r.get("cap") and r["verdict"] == "shrink" else "")
            lines.append(
                f"  {r['knob']}: {r['recommended']}  # captune: measured "
                f"peak {r['peak']} (window-end sample), x{headroom} headroom "
                f"-> ladder {r['recommended']}{was}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.captune")
    ap.add_argument("records", nargs="+",
                    help="run logs/records: ring/heartbeat JSONL, the CLI's "
                         "final JSON line, occprobe rows — any mix")
    ap.add_argument("--headroom", type=float, default=HEADROOM,
                    help=f"sizing headroom over the measured peak "
                         f"(default {HEADROOM})")
    ap.add_argument("--json", action="store_true",
                    help="emit the advisory rows as one JSON line instead "
                         "of text")
    args = ap.parse_args(argv)
    recs = load_records(args.records)
    if not recs:
        print("no JSON records found", file=sys.stderr)
        return 1
    by_cfg = {
        cfg: advise(*peaks_from_records(group), headroom=args.headroom)
        for cfg, group in group_records(recs).items()
    }
    by_cfg = {cfg: rows for cfg, rows in by_cfg.items() if rows}
    if not by_cfg:
        print("records carry no occupancy gauges (need a run with "
              "--metrics-ring, a final-metrics record with ev_max_fill, or "
              "an occprobe row)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"advice": by_cfg}))
        return 0
    for cfg, rows in by_cfg.items():
        print(f"== captune: {cfg} ==")
        for line in advise_lines(rows):
            print("  " + line)
        print("-- config-YAML (paste into the experiment file) --")
        print(render_yaml(rows, headroom=args.headroom))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

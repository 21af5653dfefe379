"""Heartbeat/tracker/ring log analysis (port of
``tools/heartbeat_report.py``, a copy: the port imports nothing of the JAX
package; the same records give the same text, summaries and CSV bytes).

The reference ships helper scripts that parse heartbeat logs into
throughput/RTT tables and plots (SURVEY §2.6 tools/). This reads the JSON
lines the CLI emits (--heartbeat → engine heartbeats on stderr; --tracker →
per-host records; --metrics-ring → per-window telemetry rows) and prints
summary tables plus optional CSVs for plotting. Record schemas are the
telemetry registry's (docs/OBSERVABILITY.md) — one namespace, not three.

    python -m shadow1_tpu_torch.tools.heartbeat_report run.log [--csv out.csv]
        [--ring-csv ring.csv]
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import sys

from shadow1_tpu_torch.telemetry.registry import (
    DROP_SPECS,
    REC_FLEET_EXP,
    REC_FLEET_QUARANTINE,
    REC_FLEET_RETRY,
    REC_FLEET_SUMMARY,
    REC_FLOW,
    REC_HEARTBEAT,
    REC_LINEAGE,
    REC_LINK,
    REC_MEM,
    REC_RESUME,
    REC_RING,
    REC_RING_GAP,
    REC_SERVE,
    REC_SERVE_DEADLINE,
    REC_SERVE_JOB,
    REC_SERVE_QUEUE,
    REC_SERVE_RETRY,
    REC_TRACKER,
    REC_WORK,
    RING_COUNTERS,
    RING_FIELDS,
    RING_GAUGES,
)

# mem.py imports torch but initialises no device at import: one byte
# formatter for every surface, never two drifting.
from shadow1_tpu_torch.mem import fmt_bytes as _fmt_bytes


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


def percentile(values: list, q: float):
    """Nearest-rank percentile on a small series (no numpy dependency)."""
    if not values:
        return None
    s = sorted(values)
    idx = math.ceil(q / 100 * len(s)) - 1
    return s[min(len(s) - 1, max(0, idx))]


def work_summary(rows: list[dict], n_hosts: int | None) -> dict | None:
    """Work-efficiency distribution (performance attribution plane).

    ``rows`` are per-window records carrying the RING_WORK columns — ring
    records from the batched engines, or the CPU oracle's ``work`` rows.
    With ``n_hosts`` known (the heartbeat ``work`` block or the final CLI
    JSON carries it) the stats are FRACTIONS: active-host fraction
    (active_hosts/H — the live signal for "0.1% of hosts pay full [cap, H]
    plane passes"), pop-scan efficiency (events popped per pop lane
    scanned, events/(rounds·H); sharded logs sum per-shard rounds, so
    treat it as per-shard-lane efficiency there) and outbox-host fraction.
    p50/p95/min — MIN because the worst window is the wasted-work story.
    These stats are deliberately NOT part of ring_summary: the RING_WORK
    columns are utilization samples, not counter deltas, and stay out of
    the occupancy percentile table (the digest/retry-column rule)."""
    series: dict[str, list] = {"active_frac": [], "pop_scan_eff": [],
                               "outbox_frac": [], "active_hosts": [],
                               "elig_events": []}
    for r in rows:
        if "active_hosts" not in r:
            continue
        series["active_hosts"].append(r["active_hosts"])
        if "elig_events" in r:
            series["elig_events"].append(r["elig_events"])
        if n_hosts:
            series["active_frac"].append(r["active_hosts"] / n_hosts)
            if "outbox_hosts" in r:
                series["outbox_frac"].append(r["outbox_hosts"] / n_hosts)
            if r.get("rounds"):
                series["pop_scan_eff"].append(
                    r.get("events", 0) / (r["rounds"] * n_hosts))
    if not series["active_hosts"]:
        return None
    out: dict = {"windows": len(series["active_hosts"])}
    if n_hosts:
        out["n_hosts"] = n_hosts
    for name, vals in series.items():
        if not vals:
            continue
        rnd = (lambda v: round(v, 6)) if n_hosts else (lambda v: v)
        out[name] = {
            "p50": rnd(percentile(vals, 50)),
            "p95": rnd(percentile(vals, 95)),
            "min": rnd(min(vals)),
        }
    return out


def _print_work(ws: dict, out) -> None:
    print(f"  windows: {ws['windows']}"
          + (f"  n_hosts: {ws['n_hosts']}" if "n_hosts" in ws else ""),
          file=out)
    labels = {
        "active_frac": "active-host fraction (active_hosts/H)",
        "pop_scan_eff": "pop-scan efficiency (events/(rounds*H))",
        "outbox_frac": "outbox-host fraction (outbox_hosts/H)",
        "active_hosts": "active hosts (absolute)",
        "elig_events": "eligible events (absolute)",
    }
    # Fractions when the host count is known; absolute counts otherwise.
    keys = (("active_frac", "pop_scan_eff", "outbox_frac")
            if "active_frac" in ws else ("active_hosts", "elig_events"))
    for key in keys:
        if key in ws:
            d = ws[key]
            print(f"  {labels[key]}: p50 {d['p50']}  p95 {d['p95']}  "
                  f"min {d['min']}", file=out)


def _log_n_hosts(recs: list[dict]) -> int | None:
    """The host count, from the heartbeat ``work`` block (preferred) or the
    CLI's final JSON record — the denominator the fractions need."""
    for r in recs:
        w = r.get("work")
        if isinstance(w, dict) and w.get("n_hosts"):
            return int(w["n_hosts"])
    for r in recs:
        if r.get("hosts") and isinstance(r.get("metrics"), dict):
            return int(r["hosts"])
    return None


def ring_summary(rings: list[dict]) -> dict:
    """Per-window occupancy distribution: p50/p95/max for each ring field.

    This is the table the rung-cap sizing debates need (docs/R6_NOTES.md):
    the chunk-averaged heartbeat hides the spikes; the ring records them."""
    out: dict = {"windows": len(rings)}
    # Digest columns (RING_DIGESTS) are identity words, not magnitudes —
    # percentiles over them are noise, so only counters/gauges rank here.
    for field in RING_COUNTERS + RING_GAUGES:
        series = [r[field] for r in rings if field in r]
        if not series:
            continue
        out[field] = {
            "p50": percentile(series, 50),
            "p95": percentile(series, 95),
            "max": max(series),
        }
    return out


def summarize(recs: list[dict], out=None) -> dict:
    # sys.stdout resolved at call time, not def time — a def-time default
    # pins whatever stream an importer (e.g. pytest capture) had installed.
    out = out if out is not None else sys.stdout
    hb = [r for r in recs if r.get("type") == REC_HEARTBEAT]
    tr = [r for r in recs if r.get("type") == REC_TRACKER]
    rings = [r for r in recs if r.get("type") == REC_RING]
    gaps = [r for r in recs if r.get("type") == REC_RING_GAP]
    works = [r for r in recs if r.get("type") == REC_WORK]
    # Early-finalized lanes' fleet_exp records reach stdout AND the stderr
    # log stream — a combined capture holds them twice: dedupe by lane.
    fleet_exp = list({r.get("exp"): r for r in recs
                      if r.get("type") == REC_FLEET_EXP}.values())
    summary: dict = {
        "heartbeats": len(hb),
        "tracker_records": len(tr),
        "ring_records": len(rings),
    }
    if fleet_exp:
        # Fleet final records: one row per experiment (events, drops,
        # restarts) — the sweep's result table. Early-finished lanes
        # (--lane-finalize) are flagged inline with the window count they
        # actually ran.
        summary["fleet_experiments"] = len(fleet_exp)
        print("== fleet experiments ==", file=out)
        for r in sorted(fleet_exp, key=lambda r: r.get("exp", 0)):
            m = r.get("metrics", {})
            drops = r.get("drops", {})
            early = (f"  [finished early at window {r.get('windows')}]"
                     if r.get("finished_early") else "")
            print(f"  exp {r.get('exp')}: seed {r.get('seed')}  "
                  f"events {m.get('events')}  "
                  f"delivered {m.get('pkts_delivered')}  "
                  f"drops {drops.get('total', 0)}  "
                  f"restarts {m.get('host_restarts', 0)}{early}",
                  file=out)
    # Fleet recovery plane (fleet/run.py): per-retry and per-quarantine
    # events plus the summary ledger. These are their OWN record types —
    # chunk-level events, not per-window rows — so like the digest/retry
    # columns they never enter the ring percentile math below.
    # Quarantine records reach BOTH stdout (the CLI result stream) and
    # stderr (the log stream) — a combined capture holds each twice, and a
    # killed+relaunched run re-emits them on replay: dedupe by lane.
    fq = list({r.get("exp"): r for r in recs
               if r.get("type") == REC_FLEET_QUARANTINE}.values())
    fr = [r for r in recs if r.get("type") == REC_FLEET_RETRY]
    early = [r for r in fleet_exp if r.get("finished_early")]
    fsum = [r for r in recs if r.get("type") == REC_FLEET_SUMMARY]
    if fq or fr or early:
        rec_sum: dict = {"chunk_retries": sum(1 for r in fr
                                              if not r.get("discarded")),
                         "quarantined": len(fq),
                         "finished_early": len(early)}
        # Per-lane retry counts: how many chunks each experiment's
        # overflow tainted (sweep-global ids from the fleet_retry
        # records). One count per RECORD even when a lane overflowed
        # several counters in the same chunk; grows rolled back by a
        # quarantine (``discarded``) are audit-only and stay out.
        per_lane: dict = {}
        for r in fr:
            if r.get("discarded"):
                continue
            gids = {g for gl in (r.get("lanes") or {}).values()
                    for g in gl}
            for g in gids:
                per_lane[g] = per_lane.get(g, 0) + 1
        if per_lane:
            rec_sum["retries_by_exp"] = per_lane
        summary["fleet_recovery"] = rec_sum
        print("== fleet recovery ==", file=out)
        print(f"  chunk retries: {rec_sum['chunk_retries']}"
              f"  quarantined lanes: {len(fq)}"
              f"  early-finished lanes: {len(early)}", file=out)
        for g, n in sorted(per_lane.items()):
            print(f"  exp {g}: tainted {n} chunk(s)", file=out)
        for r in fr:
            grown = {k: v for k, v in r.items()
                     if k in ("ev_cap", "outbox_cap", "x2x_cap")}
            tag = ("  [discarded: rolled back by a quarantine]"
                   if r.get("discarded") else "")
            print(f"  retry {r.get('retry')}: windows {r.get('windows')}"
                  f"  grown {grown}{tag}", file=out)
        for r in fq:
            print(f"  quarantine: exp {r.get('exp')} (seed "
                  f"{r.get('seed')}) — {r.get('reason')}"
                  + (f" on {r.get('knob')}" if r.get("knob") else "")
                  + f" at window {r.get('window')}; solo-resumable ckpt "
                    f"{r.get('ckpt')}", file=out)
        for r in early:
            print(f"  finished early: exp {r.get('exp')} at window "
                  f"{r.get('windows')} of {r.get('windows_configured')}",
                  file=out)
        if fsum and fsum[-1].get("quarantined"):
            print(f"  sweep completed "
                  f"{fsum[-1].get('experiments')}+"
                  f"{len(fsum[-1]['quarantined'])}q/"
                  f"{fsum[-1].get('experiments_initial')}", file=out)
    if hb:
        eps = [r["events_per_sec"] for r in hb if r.get("events_per_sec")]
        spw = [r["sim_per_wall"] for r in hb if r.get("sim_per_wall")]
        summary.update(
            sim_time_s=hb[-1]["sim_time_s"],
            wall_s=hb[-1]["wall_s"],
            events=sum(r["delta"].get("events", 0) for r in hb),
            events_per_sec_mean=round(sum(eps) / len(eps), 1) if eps else None,
            sim_per_wall_mean=round(sum(spw) / len(spw), 4) if spw else None,
            pkts_delivered=sum(r["delta"].get("pkts_delivered", 0) for r in hb),
            retransmits=sum(
                r["delta"].get("tcp_rto", 0) + r["delta"].get("tcp_fast_rtx", 0)
                for r in hb
            ),
        )
        print("== run summary ==", file=out)
        for k, v in summary.items():
            print(f"  {k}: {v}", file=out)
    if hb:
        # Drop-reason table: the heartbeat ``drops`` blocks summed over the
        # run, one labeled row per reason (telemetry.registry.DROP_SPECS).
        # Pre-drops-block logs fall back to the flat delta counters.
        drop_totals = {f: 0 for f in DROP_SPECS}
        for r in hb:
            src = r.get("drops") if isinstance(r.get("drops"), dict) else \
                r.get("delta", {})
            for f in DROP_SPECS:
                v = src.get(f)
                if isinstance(v, (int, float)):
                    drop_totals[f] += int(v)
        total_drops = sum(drop_totals.values())
        summary["drops"] = {"total": total_drops, **drop_totals}
        print("== drops by reason ==", file=out)
        if total_drops == 0:
            print("  none (clean run: every modeled event/packet survived "
                  "its bounds)", file=out)
        for f, reason in DROP_SPECS.items():
            if drop_totals[f]:
                print(f"  {f}: {drop_totals[f]}  ({reason})", file=out)
    if hb:
        # Overflow-retry plane (txn.py): heartbeat ``retries``
        # blocks carry CUMULATIVE host-side counters, so the last block is
        # the run total. Chunk-level counters, not per-window rows — they
        # are excluded from the ring percentile stats below by the same
        # rule that keeps the digest identity columns out: only
        # RING_COUNTERS/RING_GAUGES rank there.
        rt = [r["retries"] for r in hb if isinstance(r.get("retries"), dict)]
        if rt:
            last = rt[-1]
            summary["retries"] = {
                k: last.get(k)
                for k in ("policy", "chunk_retries", "retry_windows_rerun")
            }
            print("== overflow retries (transactional chunks) ==", file=out)
            print(f"  chunk_retries: {last.get('chunk_retries')}  "
                  f"windows re-run: {last.get('retry_windows_rerun')}",
                  file=out)
            if isinstance(last.get("caps"), dict):
                caps = "  ".join(f"{k}: {v}"
                                 for k, v in last["caps"].items())
                print(f"  final caps: {caps}", file=out)
    resumes = [r for r in recs if r.get("type") == REC_RESUME]
    lineage = [r for r in recs if r.get("type") == REC_LINEAGE]
    if resumes or lineage:
        # Preemption/lineage plane: how the run survived — resumes taken
        # (which generation each landed on), corrupt heads skipped,
        # watchdog kills, drains (docs/OBSERVABILITY.md §"Resume and
        # lineage records").
        wk = [r for r in lineage if r.get("event") == "watchdog_kill"]
        drains = [r for r in lineage if r.get("event") == "preempted"]
        summary["lineage"] = {
            "resumes": len(resumes),
            "fallback_skipped": sum(r.get("fallback_skipped", 0)
                                    for r in resumes),
            "watchdog_kills": len(wk),
            "preempted_drains": len(drains),
        }
        if resumes:
            summary["lineage"]["generations_kept"] = \
                resumes[-1].get("generations_kept")
        print("== lineage (preemption/resume) ==", file=out)
        for k, v in summary["lineage"].items():
            print(f"  {k}: {v}", file=out)
        for r in resumes:
            extra = (f"  ({r['fallback_skipped']} corrupt newer "
                     f"generation(s) skipped)"
                     if r.get("fallback_skipped") else "")
            print(f"  resume: generation {r.get('generation')} at "
                  f"sim_ns {r.get('win_start')}{extra}", file=out)
        for r in wk:
            print(f"  watchdog kill: sidecar stale > {r.get('stale_s')}s "
                  f"at sim_ns {r.get('sim_ns')} (attempt "
                  f"{r.get('attempt')})", file=out)
    mems = [r for r in recs if r.get("type") == REC_MEM]
    ooms = [r for r in recs if r.get("error") in ("memory_budget",
                                                  "memory_exhausted")]
    if mems or ooms:
        # Memory plane (mem.py): estimated vs reported peak
        # bytes, per-plane attribution, applied downshifts, OOM/budget
        # errors. Mem records are their own type — like the digest and
        # retry columns, none of these fields ever enter the ring
        # percentile math below (only RING_COUNTERS/RING_GAUGES rank).
        est = next((r for r in mems if r.get("event") == "estimate"), None)
        downs = [r for r in mems if r.get("event") == "downshift"]
        final = next((r for r in reversed(mems)
                      if r.get("event") == "final"), None)
        msum: dict = {}
        print("== memory (estimate vs device) ==", file=out)
        if est is not None:
            msum.update(estimated_state=est.get("estimated_state"),
                        estimated_peak=est.get("estimated_peak"),
                        budget=est.get("budget"),
                        headroom=est.get("headroom"))
            print(f"  estimated: state {_fmt_bytes(est.get('estimated_state'))}"
                  f"  resident {_fmt_bytes(est.get('estimated_resident'))}"
                  f"  peak {_fmt_bytes(est.get('estimated_peak'))}",
                  file=out)
            budget = est.get("budget")
            if budget is not None:
                print(f"  budget: {_fmt_bytes(budget)} "
                      f"({est.get('budget_source')})  headroom: "
                      f"{_fmt_bytes(est.get('headroom'))}", file=out)
            planes = {**est.get("planes", {}), **est.get("peaks", {})}
            for k, v in sorted(planes.items(), key=lambda kv: -kv[1]):
                if v:
                    print(f"  {k}: {_fmt_bytes(v)}", file=out)
        if final is not None and final.get("peak_in_use") is not None:
            msum["peak_in_use"] = final["peak_in_use"]
            print(f"  reported peak in use: "
                  f"{_fmt_bytes(final['peak_in_use'])} (backend) vs "
                  f"estimated {_fmt_bytes(final.get('estimated_peak'))}",
                  file=out)
        for r in downs:
            msum.setdefault("downshifts", []).extend(r.get("actions", []))
            acts = ", ".join(a.get("action", "?") for a in
                             r.get("actions", []))
            print(f"  downshift applied: {acts} → peak "
                  f"{_fmt_bytes(r.get('estimated_peak'))} within "
                  f"{_fmt_bytes(r.get('budget'))}", file=out)
        for r in ooms:
            msum.setdefault("errors", []).append(r["error"])
            where = (f" during {r['phase']}" if r.get("phase") else "")
            if r["error"] == "memory_budget":
                detail = (f"estimated {_fmt_bytes(r.get('estimated'))} vs "
                          f"budget {_fmt_bytes(r.get('budget'))}")
            else:  # memory_exhausted carries the runtime message instead
                detail = str(r.get("message", ""))[:160]
            print(f"  ERROR {r['error']}{where}: {detail}", file=out)
        summary["memory"] = msum
    serve_ev = [r for r in recs if r.get("type") == REC_SERVE]
    serve_jobs = [r for r in recs if r.get("type") == REC_SERVE_JOB]
    if serve_ev or serve_jobs:
        # Serve plane (serve/): the daemon's job ledger from
        # its serve.log stream. Daemon-level events, never per-window rows
        # — the same digest/retry-column rule keeps every serve field out
        # of the ring percentile math below.
        by_job: dict[str, list[dict]] = {}
        for r in serve_jobs:
            by_job.setdefault(r.get("job", "?"), []).append(r)
        batches = [r for r in serve_ev if r.get("event") == "batch_start"]
        evicts = [r for r in serve_ev if r.get("event") == "evict"]
        deadlines = [r for r in recs
                     if r.get("type") == REC_SERVE_DEADLINE]
        retries = [r for r in recs if r.get("type") == REC_SERVE_RETRY]
        cache = {"hit": 0, "miss": 0}
        for b in batches:
            if b.get("cache") in cache:
                cache[b["cache"]] += 1
        # Queue wait = admission → first batch_start, read off each job's
        # own status transitions (the spool timeline, not the ledger):
        # the backpressure plane's effect as tenants actually felt it.
        waits = []
        for rows in by_job.values():
            q_t = next((r.get("t") for r in rows
                        if r.get("state") in ("queued",
                                              "waiting_headroom")), None)
            r_t = next((r.get("t") for r in rows
                        if r.get("state") == "running"), None)
            if q_t is not None and r_t is not None and r_t >= q_t:
                waits.append(r_t - q_t)
        retry_by_job: dict[str, int] = {}
        for r in retries:
            if r.get("event") == "retry":
                for j in r.get("jobs", []):
                    retry_by_job[j] = retry_by_job.get(j, 0) + 1
        ssum = {
            "jobs": len(by_job),
            "batches": len(batches),
            "cache_hits": cache["hit"],
            "cache_misses": cache["miss"],
            "evictions": len(evicts),
            "deadline_expiries": len(deadlines),
            "batch_retries": sum(1 for r in retries
                                 if r.get("event") == "retry"),
        }
        if waits:
            ssum["queue_wait_p50_s"] = round(percentile(waits, 50), 3)
            ssum["queue_wait_p95_s"] = round(percentile(waits, 95), 3)
        if retry_by_job:
            ssum["retries_by_job"] = retry_by_job
        shutdown = next((r for r in reversed(serve_ev)
                         if r.get("event") == "shutdown"), None)
        if shutdown and isinstance(shutdown.get("ledger"), dict):
            ssum["ledger"] = shutdown["ledger"]
        summary["serve"] = ssum
        print("== serve (daemon job ledger) ==", file=out)
        print(f"  jobs: {len(by_job)}  batches: {len(batches)}  "
              f"engine cache: {cache['hit']} hit / {cache['miss']} miss"
              f"  evictions: {len(evicts)}", file=out)
        if waits:
            print(f"  queue wait: p50 {ssum['queue_wait_p50_s']}s  "
                  f"p95 {ssum['queue_wait_p95_s']}s", file=out)
        if deadlines:
            ttl = sum(1 for r in deadlines
                      if r.get("kind") == "queue_ttl")
            print(f"  deadline expiries: {len(deadlines)} "
                  f"(queue_ttl x{ttl}, running x{len(deadlines) - ttl})",
                  file=out)
        if retries:
            bisects = sum(1 for r in retries
                          if r.get("event") == "bisect")
            exhausted = sum(1 for r in retries
                            if r.get("event") == "exhausted")
            print(f"  batch retries: {ssum['batch_retries']}  "
                  f"bisections: {bisects}  exhausted: {exhausted}",
                  file=out)
        for job_id in sorted(by_job):
            rows = by_job[job_id]
            last = rows[-1]
            run = next((r for r in rows if r.get("state") == "running"
                        and "lane" in r), None)
            t0 = next((r.get("t") for r in rows
                       if r.get("t") is not None), None)
            t1 = next((r.get("t") for r in reversed(rows)
                       if r.get("t") is not None), None)
            wall = (f"  wall {t1 - t0:.1f}s"
                    if t0 is not None and t1 is not None and t1 > t0
                    else "")
            lane = (f"  lane {run['lane']}/{run['lanes']}"
                    if run is not None else "")
            cached = (f"  cache {run['cache']}"
                      if run is not None and run.get("cache") else "")
            ev = sum(1 for r in rows if r.get("state") == "evicted")
            evs = f"  evicted x{ev}" if ev else ""
            rt = (f"  retries x{retry_by_job[job_id]}"
                  if job_id in retry_by_job else "")
            fin = "  [finished early]" if last.get("finished_early") else ""
            print(f"  {job_id}: {last.get('state')}{lane}{cached}{evs}"
                  f"{rt}{wall}{fin}", file=out)
    if rings:
        # Fleet runs tag each ring row with its experiment id (``exp``):
        # group the per-window stats PER EXPERIMENT — mixing lanes would
        # blend E unrelated distributions into one meaningless percentile.
        # The id itself is a grouping key only; it never enters the math
        # (only RING_COUNTERS/RING_GAUGES rank in ring_summary).
        by_exp: dict = {}
        for r in rings:
            by_exp.setdefault(r.get("exp"), []).append(r)
        # Gap records carry the same per-experiment tag: losses attribute
        # to their own lane, never summed into another's section.
        gaps_by_exp: dict = {}
        for g in gaps:
            gaps_by_exp.setdefault(g.get("exp"), []).append(g)
        if gaps:
            summary["ring_windows_lost"] = sum(
                g.get("windows_lost", 0) for g in gaps)
        if set(by_exp) == {None}:
            groups = [(None, rings)]
        else:
            groups = sorted(by_exp.items(),
                            key=lambda kv: (kv[0] is None, kv[0]))
            summary["ring_experiments"] = len(groups)
        for exp_id, group in groups:
            rs = ring_summary(group)
            if exp_id is None:
                summary["ring"] = rs
                print("== per-window occupancy (ring) ==", file=out)
            else:
                summary.setdefault("ring_by_exp", {})[exp_id] = rs
                print(f"== per-window occupancy (ring, experiment "
                      f"{exp_id}) ==", file=out)
            print(f"  windows recorded: {rs['windows']}", file=out)
            lane_lost = sum(g.get("windows_lost", 0)
                            for g in gaps_by_exp.get(exp_id, []))
            if lane_lost:
                print(f"  WINDOWS LOST TO RING OVERWRITE: {lane_lost} "
                      f"(chunk exceeded ring depth)", file=out)
            for field in RING_FIELDS:
                if field in rs:
                    d = rs[field]
                    print(f"  {field}: p50 {d['p50']}  p95 {d['p95']}  "
                          f"max {d['max']}", file=out)
        # Work-efficiency section (performance attribution plane): the
        # RING_WORK columns as utilization distributions, per experiment
        # under --fleet. Deliberately OUTSIDE ring_summary — utilization
        # samples never enter the occupancy percentile table (the
        # digest/retry-column rule).
        n_hosts = _log_n_hosts(recs)
        for exp_id, group in groups:
            ws = work_summary(group, n_hosts)
            if ws is None:
                continue
            tag = "" if exp_id is None else f", experiment {exp_id}"
            if exp_id is None:
                summary["work"] = ws
            else:
                summary.setdefault("work_by_exp", {})[exp_id] = ws
            print(f"== work efficiency (wasted-work accounting{tag}) ==",
                  file=out)
            _print_work(ws, out)
    elif works:
        # CPU-oracle logs: the per-window ``work`` rows carry the same
        # columns (no rounds, so no pop-scan efficiency).
        ws = work_summary(works, _log_n_hosts(recs))
        if ws is not None:
            summary["work"] = ws
            print("== work efficiency (wasted-work accounting) ==",
                  file=out)
            _print_work(ws, out)
    # Capacity advisory (tools/captune.py): measured peaks vs the caps the
    # records carry — the actionable line the cap-sizing debates need.
    from shadow1_tpu_torch.tools import captune

    peaks, caps, overflow = captune.peaks_from_records(recs)
    advice = captune.advise(peaks, caps, overflow)
    if advice:
        summary["captune"] = advice
        print("== captune recommendation ==", file=out)
        for line in captune.advise_lines(advice):
            print(f"  {line}", file=out)
    if tr:
        last_per_host: dict[int, dict] = {}
        for r in tr:
            last_per_host[r["host"]] = r
        tx = sorted(
            last_per_host.values(), key=lambda r: -r.get("nic_tx_bytes", 0)
        )[:10]
        print("== top talkers (final tracker snapshot) ==", file=out)
        for r in tx:
            print(
                f"  host {r['host']}: tx {r.get('nic_tx_bytes', 0)} B, "
                f"rx {r.get('nic_rx_bytes', 0)} B, "
                f"pending {r.get('pending_events', 0)}",
                file=out,
            )
        intervals = tracker_intervals(tr)
        if intervals:
            # Interval deltas between successive tracker snapshots: the
            # tracker stream carries lifetime absolutes (log.py), so a log
            # holding several snapshots (one --tracker file per chunk, or
            # a concatenated series of runs) yields per-host RATES here —
            # the reference Tracker's interval view.
            summary["tracker_intervals"] = len(intervals)
            print("== tracker interval deltas (per-host) ==", file=out)
            for iv in intervals:
                print(f"  interval sim_s {iv['from_sim_s']} -> "
                      f"{iv['to_sim_s']}:", file=out)
                top = sorted(iv["hosts"].items(),
                             key=lambda kv: -kv[1].get("nic_tx_bytes", 0)
                             )[:10]
                for h, d in top:
                    parts = "  ".join(f"{k} +{v}" for k, v in d.items()
                                      if v)
                    print(f"    host {h}: {parts or '(no change)'}",
                          file=out)
    flows_recs = [r for r in recs if r.get("type") == REC_FLOW]
    if flows_recs:
        # Flow-probe plane (--watch / probes:): one line per watched
        # entity with its headline stats and stall findings. The full
        # series/sparkline view is tools/flowreport.py's job — this
        # section is the triage index.
        from shadow1_tpu_torch.tools.flowreport import (
            _flow_label,
            diagnose_flow,
            flow_stats,
            group_flows,
        )

        groups = group_flows(flows_recs)
        fsum: dict = {}
        print("== flows (probe plane) ==", file=out)
        for key, rows in groups.items():
            label = _flow_label(key)
            stats = flow_stats(rows)
            stalls = diagnose_flow(rows)
            fsum[label] = {**stats, "stalls": [s["kind"] for s in stalls]}
            stall_txt = ("  STALLS: " + ", ".join(s["kind"] for s in stalls)
                         if stalls else "")
            print(f"  {label}: windows {stats['windows']}  "
                  f"state {stats['tcp_state_last']}  "
                  f"cwnd {stats['cwnd_last']}  "
                  f"inflight_max {stats['inflight_max']}  "
                  f"backlog_max {stats['nic_tx_backlog_ns_max']} ns"
                  f"{stall_txt}", file=out)
        summary["flows"] = fsum
    link_recs = [r for r in recs if r.get("type") == REC_LINK]
    if link_recs:
        # Link-telemetry plane (--link-telem on): top edges by bytes and
        # by drops plus the netreport verdicts. The full weathermap
        # (heatmap, hottest path, per-edge series) is tools/netreport.py's
        # job — this section is the triage index. Link rows are their own
        # record type — like the flow/digest/retry records they never
        # enter the ring percentile math above (only REC_RING rows rank).
        from shadow1_tpu_torch.tools.netreport import (
            _fmt_edge,
            diagnose_links,
            edge_totals,
            group_edges,
        )

        edges = group_edges(link_recs)
        totals = edge_totals(edges)
        verdicts = diagnose_links(edges)
        lsum: dict = {"edges": len(totals),
                      "verdicts": [v["kind"] for v in verdicts]}
        print("== links (telemetry plane) ==", file=out)
        by_bytes = sorted(totals.items(), key=lambda kv: -kv[1]["bytes"])
        for key, t in by_bytes[:5]:
            print(f"  {_fmt_edge(key)}: pkts {t['pkts']}  "
                  f"bytes {t['bytes']}  drops {t['drops']}  "
                  f"q_max {t['queued_ns_max']} ns", file=out)
        droppy = [(k, t) for k, t in totals.items() if t["drops"]]
        droppy.sort(key=lambda kv: -kv[1]["drops"])
        for key, t in droppy[:5]:
            if (key, t) in by_bytes[:5]:
                continue
            print(f"  {_fmt_edge(key)}: drops {t['drops']} "
                  f"(loss {t['loss_drops']} down {t['link_down_drops']} "
                  f"nic {t['nic_backlog_drops']})", file=out)
        for v in verdicts:
            detail = {k: x for k, x in v.items()
                      if k not in ("kind", "edges")}
            print(f"  VERDICT {v['kind']}: {', '.join(v['edges'])}  "
                  f"{detail}", file=out)
        summary["links"] = lsum
    return summary


def tracker_intervals(tr: list[dict]) -> list[dict]:
    """Per-host counter deltas between successive tracker snapshots.

    Snapshots are the groups of records sharing one ``sim_s``; counters
    are every numeric field (cpu_busy_ns, nic bytes, app counters...).
    ``pending_events`` is a gauge, not a counter — its delta is still the
    honest "queue grew/shrank by N" signal, so it is kept, sign and all.
    Returns [] when the log holds fewer than two snapshots."""
    by_time: dict[float, dict[int, dict]] = {}
    for r in tr:
        by_time.setdefault(r.get("sim_s", 0), {})[r.get("host", 0)] = r
    times = sorted(by_time)
    out = []
    skip = ("host", "sim_s")
    for t0, t1 in zip(times, times[1:]):
        hosts: dict[int, dict] = {}
        for h, cur in sorted(by_time[t1].items()):
            prev = by_time[t0].get(h, {})
            d = {}
            for k, v in cur.items():
                if k in skip or not isinstance(v, (int, float)) \
                        or isinstance(v, bool):
                    continue
                p = prev.get(k, 0)
                if isinstance(p, (int, float)):
                    d[k] = v - p
            hosts[h] = d
        out.append({"from_sim_s": t0, "to_sim_s": t1, "hosts": hosts})
    return out


def write_heartbeat_csv(recs: list[dict], path: str) -> None:
    hb = [r for r in recs if r.get("type") == REC_HEARTBEAT]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sim_time_s", "wall_s", "events_per_sec",
                    "sim_per_wall", "events", "pkts_delivered"])
        for r in hb:
            delta = r.get("delta", {})
            w.writerow([
                r["sim_time_s"], r["wall_s"], r.get("events_per_sec"),
                r.get("sim_per_wall"), delta.get("events", 0),
                delta.get("pkts_delivered", 0),
            ])


def write_ring_csv(recs: list[dict], path: str) -> None:
    rings = [r for r in recs if r.get("type") == REC_RING]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["window", "sim_time_s", *RING_FIELDS])
        for r in rings:
            w.writerow([r.get("window"), r.get("sim_time_s"),
                        *[r.get(field) for field in RING_FIELDS]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.heartbeat_report")
    ap.add_argument("log")
    ap.add_argument("--csv", default=None,
                    help="write the heartbeat series as CSV for plotting")
    ap.add_argument("--ring-csv", default=None,
                    help="write the per-window ring series as CSV")
    args = ap.parse_args(argv)
    recs = load_records(args.log)
    if not recs:
        print("no JSON records found", file=sys.stderr)
        return 1
    summarize(recs)
    if args.csv:
        write_heartbeat_csv(recs, args.csv)
        print(f"wrote {args.csv}")
    if args.ring_csv:
        write_ring_csv(recs, args.ring_csv)
        print(f"wrote {args.ring_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

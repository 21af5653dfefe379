"""CPU reference engine — the readable discrete-event oracle.

A small, sequential heapq simulator implementing *exactly* the semantics in
docs/SEMANTICS.md: same event ordering keys, same capacity bounds, same
counter-based RNG streams, same integer arithmetic. It plays the role the
real Linux kernel played for the reference's test strategy (SURVEY §4: "the
real OS is the oracle"): every workload must produce identical event/packet/
byte counts and final clocks on this engine and on the batched engine.

Structurally it mirrors the reference's sequential scheduler policy
(src/main/core/scheduler/scheduler-policy-global-single.c): one global
priority queue, events executed in total (time, tb) order.
"""

from __future__ import annotations

import heapq
from typing import Any

import numpy as np

from portbench.reference.oracle.compiled import CompiledExperiment
from portbench.reference.oracle.consts import (
    KIND_METRIC_FIELDS,
    K_PHOLD,
    K_PKT,
    R_JITTER,
    R_LOSS,
    R_PHOLD_DELAY,
    R_PHOLD_DST,
    EngineParams,
    packet_tb,
)
from portbench.reference.oracle.rngcache import DrawCache


class CpuEngine:
    def __init__(self, exp: CompiledExperiment, params: EngineParams | None = None,
                 capture=None):
        """``capture(time_ns, src, dst, p, dropped)`` is called for every
        routed packet (pcap hook — tools/pcap.py; reference per-NIC capture,
        src/main/utility/pcap-writer.c)."""
        exp.validate()
        self.exp = exp
        self.capture = capture
        self.params = params or EngineParams()
        self.window = exp.window
        self.n_windows = int(-(-exp.end_time // self.window))
        self.draws = DrawCache(exp.seed)
        # Loss decisions are integer-threshold compares on the raw bits
        # (backend-exact; mirrors route_outbox in core/engine.py).
        from portbench.reference.oracle import rng as _rng

        self.loss_thr = _rng.prob_threshold(exp.loss_vv)
        h = exp.n_hosts
        self.heap: list[tuple] = []  # (time, tb, gseq, host, kind, p)
        self._gseq = 0
        self.pending = np.zeros(h, np.int64)   # events queued per host (ev_cap)
        self.self_ctr = np.zeros(h, np.int64)  # local push tie-break counters
        self.pkt_ctr = np.zeros(h, np.int64)   # per-src packet counters
        self._ob_win = np.full(h, -1, np.int64)  # outbox accounting: window idx
        self._ob_used = np.zeros(h, np.int64)    # ... sends used this window
        # Fidelity mirrors (docs/SEMANTICS.md; identical rules to run_round /
        # route_outbox / deliver_flat in core/engine.py). The fault plane
        # compiles through the SAME builders as the batched engines
        # (fault/schedule.py), so down predicates, outage windows and ramp
        # thresholds are the identical integers.
        from portbench.reference.oracle.compiled import NO_STOP
        from portbench.reference.oracle.schedule import (
            host_interval_tensors,
            hosts_down_at_np,
            link_tables,
            ramp_tables,
        )

        self._hosts_down_at_np = hosts_down_at_np  # hot path: bind once
        self.fault_down, self.fault_up = host_interval_tensors(exp)
        self.has_stop = bool(self.fault_down.min() < NO_STOP)
        self._link_fault = link_tables(exp)
        self._loss_ramp = ramp_tables(exp)
        self.has_link_fault = self._link_fault is not None
        self.has_loss_ramp = self._loss_ramp is not None
        self.cpu_cost = np.asarray(exp.cpu_ns_per_event, np.int64)
        self.has_cpu = bool(self.cpu_cost.max() > 0)
        self.cpu_busy = np.zeros(h, np.int64)
        self.jitter_vv = np.asarray(exp.jitter_vv, np.int64)
        self.has_jitter = bool(self.jitter_vv.max() > 0)
        self.metrics = {
            "events": 0,
            "pkts_sent": 0,
            "pkts_delivered": 0,
            "pkts_lost": 0,
            "ev_overflow": 0,
            "ob_overflow": 0,
            "down_events": 0,
            "down_pkts": 0,
            "link_down_pkts": 0,
            "host_restarts": 0,
            "nic_tx_drops": 0,
            "nic_rx_drops": 0,
            "nic_aqm_drops": 0,
            "pops_pkt": 0,
            "pops_deliver": 0,
            "pops_timer": 0,
            "pops_txr": 0,
            "pops_app": 0,
            # Capacity high-water gauges, mirroring the batch engines'
            # window-end sampling (core/engine.py window_step): the boundary
            # pending-event sets are engine-independent (all events created
            # before a window boundary with time ≥ it — eager delivery vs
            # window-end scatter land the same sets), so these match the batched
            # gauges bit-exactly on overflow-free runs.
            "ev_max_fill": 0,
            "ob_max_fill": 0,
            # Wasted-work accounting (performance attribution plane):
            # running sums of the per-window boundary samples, mirroring
            # core/engine.window_phases ph_prepare/deliver_window. Same
            # engine-independence argument as the fill gauges: the
            # window-start pending set and the per-window send set are
            # identical across engines on overflow-free runs.
            "active_hosts": 0,
            "elig_events": 0,
            "outbox_hosts": 0,
        }
        self._next_boundary = self.window  # first window-end sample point
        # Per-kind pop occupancy fields (shared table — consts).
        self._pops_field = {k: f[0] for k, f in KIND_METRIC_FIELDS.items()}
        # Determinism flight recorder (core/digest.py): the oracle mirrors
        # the batched engines' per-window subsystem digests at window
        # boundaries. The pending-event digest is maintained incrementally
        # (add the element word on push, subtract it on pop — the sum is
        # order-independent, so this equals the batched engine's plane scan); outbox
        # send words accumulate per window as sends happen; plane digests
        # (tcp/nic/rng) are recomputed per boundary from live state. Rows
        # land in ``digest_rows`` as JSONL-ready REC_DIGEST dicts.
        self.digest_on = bool(self.params.state_digest)
        # Overflow policy / self-check at window boundaries (txn.py): the
        # oracle runs the SAME boundary checks as the chunked batch runner
        # — "halt" raises the structured CapacityExceededError on fresh
        # overflow, --selfcheck verifies the drop-accounting identity.
        # "retry" is inert here like auto_caps: the eager oracle cannot
        # re-run a window (the CLI warns; parity tests compare a batched
        # retry run against the oracle run at the final caps instead).
        self._halt_on_overflow = self.params.on_overflow == "halt"
        self._selfcheck = bool(self.params.selfcheck)
        self._of_seen = {"ev_overflow": 0, "ob_overflow": 0}
        self._ev_dg = 0
        self._ev_word: dict[int, int] = {}  # gseq → element word
        self._ob_dg: dict[int, int] = {}    # window → send-word sum
        self.digest_rows: list[dict] = []
        # Wasted-work accounting (performance attribution plane): per-window
        # boundary samples, mirroring the batched engines' ring columns
        # (telemetry/registry.RING_WORK). Gated on metrics_ring like the
        # digest rows — the per-boundary heap scan is pay-for-use, and the
        # ring is where the batched engines carry the per-window values.
        # Rows land in ``work_rows`` as JSONL-ready REC_WORK dicts; the
        # cumulative metrics counters advance in lockstep so final counters
        # compare bit-exactly against the batched engines.
        self.work_on = self.params.metrics_ring > 0
        self.work_rows: list[dict] = []
        # Flow-probe plane (telemetry/probes.py): the oracle samples the
        # same watched (host, sock) columns at every window boundary as the
        # batched engines' probe ring, into JSONL-ready REC_FLOW dicts.
        # i32-semantics columns mask with & 0xFFFFFFFF (the u32 widen's
        # twin); inflight stays the signed seq distance. No ring needed —
        # rows accumulate directly.
        self.probe_on = bool(self.params.probes)
        self.probe_rows: list[dict] = []
        # Link-telemetry plane (telemetry/links.py): the oracle maintains
        # the same cumulative [V, V, F] per-edge accumulator — offered
        # packets / wire bytes / queued ns at the send gates below, drop
        # partition at the matching gate, NIC drop-tail drops via
        # _link_nic_drop from the model's _tx — and emits the same
        # cumulative ``link`` snapshot records at run boundaries
        # (link_rows). Bit-exact against the batched engines at any window
        # boundary: every column is a sum/max over the same per-packet
        # integers, and summation order cannot matter.
        self.link_on = bool(self.params.link_telem)
        self.link_rows: list[dict] = []
        self._link_next = 0  # last drained window boundary (never re-emit)
        if self.link_on:
            raise ValueError("the frozen oracle carries no link plane")
        self._work_pending: dict[int, dict] = {}  # window → open row
        self._ob_hosts: dict[int, int] = {}       # window → distinct senders
        self._work_next_open = 0                  # next window to sample
        self.model = self._make_model()
        self.model.start()
        # Seed-time overflow is baselined out, mirroring the batch guard's
        # bind-after-init_state: only overflow DURING a window is fresh.
        self._of_seen = {c: self.metrics[c] for c in self._of_seen}
        # Host restart schedule (fault plane): every finite window-quantized
        # up boundary, sorted — a restarted host's model columns restore to
        # the POST-start snapshot captured here (the oracle twin of the
        # batched engines' init-model capture: same moment in the lifecycle,
        # before any event has run), its virtual-CPU clock zeroes, and its
        # event heap entries are deliberately untouched (dead-interval ones
        # discard at pop; later ones execute against the reset state).
        self._restart_sched: list[tuple[int, list[int]]] = []
        self._restart_i = 0
        self._cur_end = 0
        if (self.fault_up < NO_STOP).any():
            by_b: dict[int, list[int]] = {}
            ks, hs = np.nonzero(self.fault_up < NO_STOP)
            for k, h_ in zip(ks, hs):
                by_b.setdefault(int(self.fault_up[k, h_]), []).append(int(h_))
            self._restart_sched = sorted(
                (b, sorted(v)) for b, v in by_b.items()
            )
            self._restart_snap = self.model.snapshot_host_state()

    def _make_model(self):
        if self.exp.model == "phold":
            return CpuPhold(self)
        if self.exp.model == "net":
            from portbench.reference.oracle.net import CpuNetModel

            return CpuNetModel(self)
        raise ValueError(f"unknown model {self.exp.model!r}")

    # -- fault plane (mirrors fault/plane.py on the shared tables) --------
    def _down_at(self, host: int, t: int) -> bool:
        """Host ``host`` is down at time ``t`` (any interval contains t)."""
        return self._hosts_down_at_np(self.fault_down, self.fault_up, host, t)

    def _link_down(self, vs: int, vd: int, dep: int) -> bool:
        src, dst, t0, t1 = self._link_fault
        return bool(((vs == src) & (vd == dst)
                     & (dep >= t0) & (dep < t1)).any())

    def _ramp_thr(self, vs: int, vd: int, dep: int, thr: int) -> int:
        src, dst, t0, t1, rthr = self._loss_ramp
        for i in range(len(src)):
            if (vs == src[i] and vd == dst[i]
                    and t0[i] <= dep < t1[i]):
                thr = int(rthr[i])  # entries in order: later wins
        return thr

    def _apply_restarts_pending(self, upto: int) -> bool:
        """Apply every scheduled restart whose boundary b satisfies
        b ≤ upto, b < the current run end (the batched engine only runs
        window starts < end), and b < the next UNprocessed boundary (its
        digest row — the pre-restart state — must already be emitted).
        Returns True if any host was reset (digest planes then stale)."""
        applied = False
        while self._restart_i < len(self._restart_sched):
            b, hosts = self._restart_sched[self._restart_i]
            if b > upto or b >= self._cur_end or b >= self._next_boundary:
                break
            for h_ in hosts:
                self.model.reset_host(h_, self._restart_snap)
                self.cpu_busy[h_] = 0
                self.metrics["host_restarts"] += 1
            self._restart_i += 1
            applied = True
        return applied

    # -- scheduling primitives (semantics shared with the batched engine) -----
    def schedule_local(self, host: int, time: int, kind: int, p: tuple) -> None:
        if self.pending[host] >= self.params.ev_cap:
            self.metrics["ev_overflow"] += 1
            return
        tb = int(self.self_ctr[host])
        self.self_ctr[host] += 1
        self._push(time, tb, host, kind, p)

    def outbox_space(self, host: int, now: int) -> int:
        w = now // self.window
        if self._ob_win[host] != w:
            self._ob_win[host] = w
            self._ob_used[host] = 0
        return self.params.outbox_cap - int(self._ob_used[host])

    def send(self, src: int, dst: int, kind: int, depart: int, p: tuple, now: int) -> bool:
        """Route one packet: NIC outbox accounting, path latency, loss draw.

        ``depart`` is the time the packet leaves the src NIC; the outbox slot
        is consumed in the window containing the handler's ``now`` (the batched engine
        engine drains and resets outboxes at each window end).
        """
        if self.outbox_space(src, now) <= 0:
            self.metrics["ob_overflow"] += 1
            return False
        self._ob_used[src] += 1
        if int(self._ob_used[src]) > self.metrics["ob_max_fill"]:
            self.metrics["ob_max_fill"] = int(self._ob_used[src])
        if self.work_on and int(self._ob_used[src]) == 1:
            # First outbox slot this host touched this window — the
            # outbox_hosts gauge's element (deliver_window counts cnt > 0
            # at window end; the sets are identical).
            w = now // self.window
            self._ob_hosts[w] = self._ob_hosts.get(w, 0) + 1
        ctr = int(self.pkt_ctr[src])
        self.pkt_ctr[src] += 1
        if self.digest_on:
            # The send occupies an outbox slot in the window of ``now`` —
            # hashed before the loss draw, exactly like the batched outbox
            # (loss is drawn at routing time, after the slot was consumed).
            from portbench.reference.oracle.digest import packet_word

            w = now // self.window
            self._ob_dg[w] = self._ob_dg.get(w, 0) + packet_word(
                src, dst, depart, ctr, kind, p
            )
        self.metrics["pkts_sent"] += 1
        vs = int(self.exp.host_vertex[src])
        vd = int(self.exp.host_vertex[dst])
        if self.link_on:
            # Offered on the edge (the pkts_sent population): counts, wire
            # bytes, NIC queueing ns — mirror of link_route_accum's scatter
            # (depart − window start of the send window; the batched engine routes at
            # the end of the window the outbox slot was consumed in).
            from portbench.reference.oracle.consts import WIRE_OVERHEAD

            a = self._link_acc[vs, vd]
            a[0] += 1
            a[1] += (int(p[4]) if len(p) > 4 else 0) + WIRE_OVERHEAD
            q = depart - (now // self.window) * self.window
            a[5] += q
            if q > a[6]:
                a[6] = q
        if self.has_link_fault and self._link_down(vs, vd, depart):
            # Link outage (fault plane): deterministic drop on departure,
            # BEFORE the loss draw — counted separately, never in
            # pkts_lost (route_outbox orders the gates identically).
            self.metrics["link_down_pkts"] += 1
            if self.link_on:
                self._link_acc[vs, vd, 3] += 1
            if self.capture is not None:
                self.capture(depart, src, dst, p, True)
            return True
        thr = int(self.loss_thr[vs, vd])
        if self.has_loss_ramp:
            thr = self._ramp_thr(vs, vd, depart, thr)
        if int(self.draws.bits(R_LOSS, src, ctr)) < thr:
            self.metrics["pkts_lost"] += 1
            if self.link_on:
                self._link_acc[vs, vd, 2] += 1
            if self.capture is not None:
                self.capture(depart, src, dst, p, True)
            return True
        arrival = depart + int(self.exp.lat_vv[vs, vd])
        if self.has_jitter:
            jit = int(self.jitter_vv[vs, vd])
            if jit:
                arrival += self.draws.randint(R_JITTER, src, ctr, 2 * jit + 1) - jit
        if self.has_stop and self._down_at(dst, arrival):
            self.metrics["down_pkts"] += 1
            return True
        if self.pending[dst] >= self.params.ev_cap:
            self.metrics["ev_overflow"] += 1
            return True
        self._push(arrival, packet_tb(src, ctr), dst, kind, p)
        self.metrics["pkts_delivered"] += 1
        if self.capture is not None:
            self.capture(arrival, src, dst, p, False)
        return True

    def schedule_packet(self, host: int, time: int, tb: int, kind: int,
                        p: tuple) -> None:
        """Push with a caller-supplied tie-break (the packet's own): used by
        the NIC rx fast path, which converts a just-popped K_PKT slot in
        place — capacity cannot overflow (the pop freed a slot)."""
        assert self.pending[host] < self.params.ev_cap
        self._push(time, tb, host, kind, p)

    def _push(self, time: int, tb: int, host: int, kind: int, p: tuple) -> None:
        self.pending[host] += 1
        if self.digest_on:
            from portbench.reference.oracle.digest import event_word

            w = event_word(host, time, tb, kind, p)
            self._ev_word[self._gseq] = w
            self._ev_dg += w
        heapq.heappush(self.heap, (time, tb, self._gseq, host, kind, p))
        self._gseq += 1

    def _sample_fill(self, upto: int) -> None:
        """Window-end occupancy samples for every boundary ≤ ``upto``
        (exclusive of later ones): between two events the pending sets are
        static, so sampling when the next event's time crosses a boundary
        sees exactly the state the batch engine gauges at window end —
        and, with digests on, exactly the state the batch engine digests
        there (docs/SEMANTICS.md: the boundary pending/live sets are
        engine-independent). Host restart resets interleave here in
        boundary order: a restart at boundary b applies AFTER the digest
        row for window b/W−1 (the pre-restart state) and before any event
        with time ≥ b — exactly where window_step applies it."""
        self._apply_restarts_pending(upto)
        if self._next_boundary > upto:
            return
        # Window index of the FIRST boundary crossed now — the window the
        # boundary checks below attribute fresh overflow / violations to
        # (no event ran between consecutive skipped boundaries, so the
        # counters cannot have moved after the first one).
        first_w = self._next_boundary // self.window - 1
        fill = int(self.pending.max()) if self.pending.size else 0
        if fill > self.metrics["ev_max_fill"]:
            self.metrics["ev_max_fill"] = fill
        if not self.digest_on and not self.work_on and not self.probe_on:
            n_skipped = (upto - self._next_boundary) // self.window + 1
            self._next_boundary += n_skipped * self.window
            self._apply_restarts_pending(upto)
            self._boundary_checks(first_w)
            return
        # One pass per boundary. The plane digests are static across a
        # multi-boundary stretch (no event ran in between, and no restart
        # fired — a restart invalidates the cache) — computed once; only
        # the per-window outbox sums differ (0 for idle windows, matching
        # the batched engine's empty-outbox digest). The work-gauge samples, by
        # contrast, move per boundary (the eligibility bound advances one
        # window each time), so they are recomputed per window from the
        # static heap.
        if self.digest_on:
            from portbench.reference.oracle.registry import REC_DIGEST

            dg_tcp, dg_nic, dg_rng = self._digest_planes()
        while self._next_boundary <= upto:
            b = self._next_boundary
            w = b // self.window - 1
            if self.digest_on:
                self.digest_rows.append({
                    "type": REC_DIGEST,
                    "window": w,
                    "dg_evbuf": self._ev_dg,
                    "dg_outbox": self._ob_dg.pop(w, 0),
                    "dg_tcp": dg_tcp,
                    "dg_nic": dg_nic,
                    "dg_rng": dg_rng,
                })
            if self.probe_on:
                self._probe_sample(b, w)
            if self.work_on:
                self._work_close(w)
            self._next_boundary += self.window
            if self._apply_restarts_pending(b) and self.digest_on:
                dg_tcp, dg_nic, dg_rng = self._digest_planes()
            if self.work_on:
                self._work_catchup()
        self._boundary_checks(first_w)

    # -- wasted-work accounting (performance attribution plane) -----------
    def _work_catchup(self) -> None:
        """Open the window-start work sample of every window whose start
        boundary has been crossed (all earlier events executed — the heap
        IS the engine-independent boundary pending set) and that this run
        will actually execute (start < run end). Monotonic, so incremental
        run() continuations (paritytrace lockstep chunks) sample each
        window exactly once, including window 0 on the first call."""
        while (self._work_next_open * self.window < self._cur_end
               and self._work_next_open * self.window < self._next_boundary):
            self._work_open(self._work_next_open * self.window)
            self._work_next_open += 1

    def _work_open(self, b: int) -> None:
        """Window-start sample for the window beginning at sim time ``b``:
        active hosts (≥1 pending event with time < b+W) and eligible
        events — exactly the raw window-start set core/engine.window_phases
        ph_prepare gauges before the NIC arrival batch rewrites times."""
        from portbench.reference.oracle.registry import REC_WORK

        bound = b + self.window
        hosts = set()
        n_el = 0
        for ent in self.heap:
            if ent[0] < bound:
                n_el += 1
                hosts.add(ent[3])
        self.metrics["active_hosts"] += len(hosts)
        self.metrics["elig_events"] += n_el
        self._work_pending[b // self.window] = {
            "type": REC_WORK, "window": b // self.window,
            "active_hosts": len(hosts), "elig_events": n_el,
        }

    def _work_close(self, w: int) -> None:
        """Window-end half of the sample: the distinct-sender count the
        batched engine reads off the outbox ``cnt`` plane before its
        window-end clear."""
        row = self._work_pending.pop(w, None)
        if row is None:
            return
        n = self._ob_hosts.pop(w, 0)
        self.metrics["outbox_hosts"] += n
        row["outbox_hosts"] = n
        self.work_rows.append(row)

    def _boundary_checks(self, w: int) -> None:
        """The overflow halt and the self-check are the run's business, not
        the reference's: the benchmark counts a lane-pass that overflowed as
        failed, and the reference reproduces the counters."""

    def _probe_sample(self, b: int, w: int) -> None:
        """One REC_FLOW row per watched (host, sock) at boundary ``b`` —
        the oracle twin of telemetry/probes.probe_sample. i32-semantics TCP
        columns mask with & 0xFFFFFFFF (the batched engines widen the same
        i32 planes through u32); ``inflight`` is the signed seq distance;
        NIC backlog is free-time relative to the boundary."""
        from portbench.reference.oracle.consts import SEC, seq_sub
        from portbench.reference.oracle.registry import PROBE_FIELDS, REC_FLOW

        model = self.model
        has_net = hasattr(model, "socks")
        t = round(b / SEC, 9)
        m32 = 0xFFFFFFFF
        for gh, sock in self.params.probes:
            cols = dict.fromkeys(PROBE_FIELDS, 0)
            if has_net and sock >= 0:
                k = model.socks[gh][sock]
                cols["tcp_state"] = k.st & m32
                cols["cwnd"] = k.cwnd & m32
                cols["ssthresh"] = k.ssthresh & m32
                cols["snd_max"] = k.snd_max & m32
                cols["peer_wnd"] = k.peer_wnd & m32
                cols["inflight"] = seq_sub(k.snd_nxt, k.snd_una)
                cols["srtt"] = int(k.srtt)
                cols["rttvar"] = int(k.rttvar)
                cols["rto"] = int(k.rto)
            if has_net:
                cols["nic_tx_backlog_ns"] = max(int(model.tx_free[gh]) - b, 0)
                cols["nic_rx_backlog_ns"] = max(int(model.rx_free[gh]) - b, 0)
                cols["nic_tx_bytes"] = int(model.tx_bytes[gh])
                cols["nic_rx_bytes"] = int(model.rx_bytes[gh])
            cols["pending_events"] = int(self.pending[gh])
            rec = {
                "type": REC_FLOW,
                "window": w,
                "sim_time_s": t,
                "host": int(gh),
                "sock": int(sock),
            }
            rec.update({f: int(cols[f]) for f in PROBE_FIELDS})
            self.probe_rows.append(rec)

    def _link_nic_drop(self, src: int, dst: int) -> None:
        """Egress-edge attribution of a NIC uplink drop-tail drop — the
        oracle twin of telemetry.links.link_nic_drops (called from the
        model's _tx at the exact nic_tx_drops site; RED drops excluded)."""
        if self.link_on:
            vs = int(self.exp.host_vertex[src])
            vd = int(self.exp.host_vertex[dst])
            self._link_acc[vs, vd, 4] += 1

    def _drain_links(self, done: int) -> None:
        """Cumulative per-edge ``link`` snapshots at window boundary
        ``done`` — field-for-field the records telemetry.links.drain_links
        emits from the batched accumulator at the same boundary. The
        cursor keeps run() continuations (paritytrace lockstep chunks)
        from re-emitting a boundary."""
        if not self.link_on or done <= self._link_next:
            return
        from portbench.reference.oracle.consts import SEC
        from portbench.reference.oracle.registry import LINK_FIELDS, REC_LINK

        self._link_next = done
        t = round(done * self.window / SEC, 9)
        for vs, vd in zip(*np.nonzero(self._link_acc.any(axis=-1))):
            rec = {
                "type": REC_LINK,
                "window": done - 1,
                "sim_time_s": t,
                "src_vertex": int(vs),
                "dst_vertex": int(vd),
            }
            rec.update({f: int(x) for f, x in
                        zip(LINK_FIELDS, self._link_acc[vs, vd])})
            self.link_rows.append(rec)

    def _digest_planes(self) -> tuple[int, int, int]:
        """(dg_tcp, dg_nic, dg_rng) of the CURRENT state — the oracle twins
        of core/digest.py's plane digests, same element words, same field
        order."""
        from portbench.reference.oracle import digest as D

        model = self.model
        dg_tcp = dg_nic = 0
        extras: list = []
        if hasattr(model, "socks"):  # net model: tcp + nic planes
            from portbench.reference.oracle.consts import TCP_FREE

            dg_tcp = D.digest_socks_np([
                (h, s, k) for h, socks in enumerate(model.socks)
                for s, k in socks.made() if k.st != TCP_FREE])
            dg_nic = D.digest_nic_np(model.tx_free, model.rx_free,
                                     model.tx_bytes, model.rx_bytes,
                                     model.aqm_ctr)
        elif hasattr(model, "hops"):  # phold: draw counters are model state
            extras = [model.hops, model.ctr]
        dg_rng = D.digest_rng_np(
            [self.self_ctr, self.pkt_ctr, self.cpu_busy] + extras
        )
        return dg_tcp, dg_nic, dg_rng

    # -- main loop ---------------------------------------------------------
    def run(self, n_windows: int | None = None) -> dict[str, Any]:
        end = (self.n_windows if n_windows is None else n_windows) * self.window
        # Restart resets apply only at window starts the batched engine
        # actually runs (win_start < end); a boundary AT the run end defers
        # to a later run() continuation (paritytrace's lockstep chunks).
        self._cur_end = max(self._cur_end, end)
        if self.work_on:
            self._work_catchup()
        rx_batch = getattr(self.model, "rx_batch", False)
        while self.heap and self.heap[0][0] < end:
            self._sample_fill(int(self.heap[0][0]))
            time, tb, _g, host, kind, p = heapq.heappop(self.heap)
            self.pending[host] -= 1
            if self.digest_on:
                self._ev_dg -= self._ev_word.pop(_g)
            # churn: a dead host discards its events (core run_round rule)
            if self.has_stop and self._down_at(host, time):
                self.metrics["down_events"] += 1
                continue
            # NIC arrival fast path: rx processing is plumbing, not an event
            # — no event count, no virtual-CPU charge (mirror of the batched
            # engine's window-start conversion, net.make_pre_window).
            if kind == K_PKT and rx_batch:
                self.model.rx_convert(host, time, tb, p)
                continue
            # virtual CPU (host/cpu.c): execute at eff = max(time, busy); an
            # execution slipping past the window boundary re-queues at
            # (eff, original tb) unexecuted — identical rule to run_round.
            if self.has_cpu:
                eff = max(time, int(self.cpu_busy[host]))
                if eff >= (time // self.window + 1) * self.window:
                    self._push(eff, tb, host, kind, p)
                    continue
                self.cpu_busy[host] = eff + int(self.cpu_cost[host])
                time = eff
            self.metrics["events"] += 1
            f = self._pops_field.get(kind)
            if f:
                self.metrics[f] += 1
            self.model.handle(host, time, kind, p)
        # Remaining boundaries up to the run end see a static pending set.
        self._sample_fill(end)
        self._drain_links(end // self.window)
        return dict(self.metrics)

    def summary(self) -> dict[str, Any]:
        return self.model.summary()


def snap_host_arrays(obj, n_hosts: int) -> dict[str, np.ndarray]:
    """Copy every per-host numpy attribute of ``obj`` (host axis 0 — the
    oracle layout convention, transposed from the batch engines' host-minor
    tensors). Config arrays that happen to match are harmless: restoring a
    never-mutated array is the identity, exactly like the batched engines'
    whole-model column reset (fault/plane.reset_host_columns)."""
    return {
        k: v.copy() for k, v in vars(obj).items()
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n_hosts
    }


def reset_host_arrays(obj, snap: dict[str, np.ndarray], host: int) -> None:
    for k, v in snap.items():
        getattr(obj, k)[host] = v[host]


class CpuPhold:
    """Oracle PHOLD (the semantics of docs/SEMANTICS.md)."""

    def __init__(self, eng: CpuEngine):
        self.eng = eng
        cfg = eng.exp.model_cfg
        self.mean = float(cfg["mean_delay_ns"])
        self.init_events = int(cfg.get("init_events", 1))
        self.hops = np.zeros(eng.exp.n_hosts, np.int64)
        self.ctr = np.zeros(eng.exp.n_hosts, np.int64)

    def start(self) -> None:
        for h in range(self.eng.exp.n_hosts):
            for _ in range(self.init_events):
                self.eng.schedule_local(h, 0, K_PHOLD, ())

    # -- fault-plane restart (mirror of the init-model column reset) ------
    def snapshot_host_state(self):
        return snap_host_arrays(self, self.eng.exp.n_hosts)

    def reset_host(self, host: int, snap) -> None:
        reset_host_arrays(self, snap, host)

    def handle(self, host: int, time: int, kind: int, p: tuple) -> None:
        d = self.eng.draws
        ctr = int(self.ctr[host])
        delay = d.exponential_ns(R_PHOLD_DELAY, host, ctr, self.mean)
        dst = d.randint(R_PHOLD_DST, host, ctr, self.eng.exp.n_hosts)
        self.ctr[host] += 1
        self.hops[host] += 1
        t_next = time + delay
        if dst == host:
            self.eng.schedule_local(host, t_next, K_PHOLD, ())
        else:
            self.eng.send(host, dst, K_PHOLD, t_next, (), now=time)

    def summary(self) -> dict[str, Any]:
        return {"hops": self.hops, "total_hops": int(self.hops.sum())}

"""CPU oracle mirror of the "net" model: NIC + TCP/UDP + model apps.

A readable per-host, per-socket object implementation of exactly the
semantics in docs/SEMANTICS.md and shadow1_tpu_torch/tcp/tcp.py — same operation
order, same integer arithmetic, same capacity gates — so event streams and
all counters match the batched engine bit-for-bit. Structurally this is the
shape of the reference's C host stack (one Host object owning NIC state and
a descriptor table, SURVEY §2.3); the batched engine is the same machine
transposed to SoA tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from shadow1_tpu_torch.consts import (
    F_ACK,
    F_DGRAM,
    F_FIN,
    F_SYN,
    K_APP,
    K_PKT,
    K_PKT_DELIVER,
    K_TCP_TIMER,
    K_TX_RESUME,
    N_ACCEPTED,
    N_CLOSED,
    N_DATA,
    N_DGRAM,
    N_ESTABLISHED,
    N_MSG,
    N_PEER_FIN,
    N_SPACE,
    R_AQM,
    TCP_CLOSE_WAIT,
    TCP_CLOSING,
    TCP_ESTABLISHED,
    TCP_FIN_WAIT_1,
    TCP_FIN_WAIT_2,
    TCP_FREE,
    TCP_LAST_ACK,
    TCP_LISTEN,
    TCP_SYN_RCVD,
    TCP_SYN_SENT,
    CWND_MAX,
    SSTHRESH_INIT,
    TCP_CONN_STATES,
    TCP_RCV_STATES,
    TCP_SENDABLE_STATES,
    WIRE_OVERHEAD,
    ser_delay_ns,
    seq_add,
    seq_le,
    seq_lt,
    seq_sub,
)

SENDABLE = set(TCP_SENDABLE_STATES)
CONN_STATES = set(TCP_CONN_STATES)
RCV_STATES = set(TCP_RCV_STATES)


class CpuSock:
    __slots__ = (
        "st", "peer_host", "peer_sock", "snd_una", "snd_nxt", "snd_max", "rcv_nxt",
        "app_end", "fin_pend", "cwnd", "ssthresh", "peer_wnd", "dupacks",
        "recover", "srtt", "rttvar", "rto", "rtx_t", "timer_armed",
        "ts_act", "ts_seq", "ts_time", "txr", "mq",
    )

    def __init__(self):
        self.st = TCP_FREE
        self.peer_host = 0
        self.peer_sock = 0
        self.snd_una = 0
        self.snd_nxt = 0
        self.snd_max = 0
        self.rcv_nxt = 0
        self.app_end = 0
        self.fin_pend = 0
        self.cwnd = 0
        self.ssthresh = 0
        self.peer_wnd = 0
        self.dupacks = 0
        self.recover = 0
        self.srtt = 0
        self.rttvar = 0
        self.rto = 0
        self.rtx_t = 0
        self.timer_armed = False
        self.ts_act = False
        self.ts_seq = 0
        self.ts_time = 0
        self.txr = 0
        self.mq: list[tuple[int, int]] = []  # (end_seq, meta)

    def init_conn(self, pr, peer_host, peer_sock, state, rcv_nxt):
        self.st = state
        self.peer_host = peer_host
        self.peer_sock = peer_sock
        self.snd_una = 0
        self.snd_nxt = 0
        self.snd_max = 0
        self.rcv_nxt = rcv_nxt
        self.app_end = 1
        self.fin_pend = 0
        self.cwnd = pr.init_cwnd_mss * pr.mss
        self.ssthresh = SSTHRESH_INIT
        self.peer_wnd = pr.mss
        self.srtt = 0
        self.rttvar = 0
        self.rto = pr.rto_init
        self.rtx_t = 0
        self.dupacks = 0
        self.recover = 0
        self.ts_act = False
        self.txr = 0
        self.mq = []


class CpuNetModel:
    def __init__(self, eng):
        self.eng = eng
        self.pr = eng.params
        h = eng.exp.n_hosts
        self.n_hosts = h
        self.tx_free = np.zeros(h, np.int64)
        self.rx_free = np.zeros(h, np.int64)
        self.tx_bytes = np.zeros(h, np.int64)
        self.rx_bytes = np.zeros(h, np.int64)
        # Finite NIC queues (router.c drop-tail; mirror of net/nic.py).
        from shadow1_tpu_torch.core.engine import aqm_tables_np, qlen_ns_np

        self.tx_qlen_ns = qlen_ns_np(eng.exp.tx_qlen_bytes, eng.exp.bw_up)
        self.rx_qlen_ns = qlen_ns_np(eng.exp.rx_qlen_bytes, eng.exp.bw_dn)
        self.has_tx_qlen = bool(np.asarray(eng.exp.tx_qlen_bytes).max() > 0)
        self.has_rx_qlen = bool(np.asarray(eng.exp.rx_qlen_bytes).max() > 0)
        # Without an rx queue bound, NIC arrival processing is plumbing, not
        # an event: the engine run loop short-circuits K_PKT to rx_convert
        # (mirror of net.make_pre_window's batched conversion). Virtual-CPU
        # configs keep the per-event path so arrivals charge cpu time
        # per event.
        self.rx_batch = not (self.has_rx_qlen
                             or bool(np.asarray(eng.exp.cpu_ns_per_event).max() > 0))
        # RED AQM on the uplink (mirror of net/nic.py tx_stamp — identical
        # integer thresholds from the one shared table builder).
        self.aqm_min_ns, self.aqm_span_ns, self.aqm_pmax_thr = aqm_tables_np(
            eng.exp
        )
        self.has_aqm = bool(np.asarray(eng.exp.aqm_max_bytes).max() > 0)
        self.aqm_ctr = np.zeros(h, np.int64)
        self.socks = [
            [CpuSock() for _ in range(self.pr.sockets_per_host)] for _ in range(h)
        ]
        for k in ("tcp_fast_rtx", "tcp_rto", "tcp_ooo_drops"):
            eng.metrics[k] = 0
        name = eng.exp.model_cfg["app"]
        if name == "filexfer":
            self.app = CpuFilexfer(self)
        elif name == "dgram":
            self.app = CpuDgram(self)
        elif name == "tgen":
            from shadow1_tpu_torch.cpu_engine.apps import CpuTgen

            self.app = CpuTgen(self)
        elif name == "tor":
            from shadow1_tpu_torch.cpu_engine.apps import CpuTor

            self.app = CpuTor(self)
        elif name == "bitcoin":
            from shadow1_tpu_torch.cpu_engine.apps import CpuBitcoin

            self.app = CpuBitcoin(self)
        else:
            raise ValueError(name)

    def start(self):
        self.app.start()

    # ------------------------------------------------------------------
    # Fault-plane restart (mirror of fault/plane.reset_host_columns over
    # the batched engines' init-model capture: NIC clocks/counters, every
    # socket — listen state included — and all per-host app state restore
    # to their post-start values; engine-level event/tb counters and the
    # pending heap are deliberately NOT touched, on either engine).
    # ------------------------------------------------------------------
    def snapshot_host_state(self):
        from shadow1_tpu_torch.cpu_engine.engine import snap_host_arrays

        socks = [
            [
                {f: (list(getattr(k, f)) if f == "mq" else getattr(k, f))
                 for f in CpuSock.__slots__}
                for k in per_host
            ]
            for per_host in self.socks
        ]
        return {
            "nic": snap_host_arrays(self, self.n_hosts),
            "app": snap_host_arrays(self.app, self.n_hosts),
            "socks": socks,
        }

    def reset_host(self, host: int, snap) -> None:
        from shadow1_tpu_torch.cpu_engine.engine import reset_host_arrays

        reset_host_arrays(self, snap["nic"], host)
        reset_host_arrays(self.app, snap["app"], host)
        for s, d in enumerate(snap["socks"][host]):
            k = self.socks[host][s]
            for f, v in d.items():
                setattr(k, f, list(v) if f == "mq" else v)

    # ------------------------------------------------------------------
    # NIC + packet emission (mirror of tcp.py _emit / net.udp_send)
    # ------------------------------------------------------------------
    def rx_convert(self, host: int, time: int, tb: int, p: tuple) -> None:
        """NIC arrival (rx_batch path): reserve the downlink FIFO and push
        the deliver event with the PACKET's tie-break — bit-identical to the
        batched engine's window-start conversion (net.make_pre_window)."""
        wire = p[4] + WIRE_OVERHEAD
        ready = max(time, int(self.rx_free[host]))
        self.rx_free[host] = ready + ser_delay_ns(wire, int(self.eng.exp.bw_dn[host]))
        self.rx_bytes[host] += wire
        self.eng.schedule_packet(host, ready, tb, K_PKT_DELIVER, p)

    def _tx(self, host: int, wire: int, now: int, dst: int) -> int | None:
        """Reserve the uplink; None = dropped (RED early-drop, then
        drop-tail on the queue bound — the order tx_stamp uses). ``dst``
        is the destination host, for the link plane's egress-edge
        attribution of drop-tail drops."""
        if self.has_aqm:
            ctr = int(self.aqm_ctr[host])
            self.aqm_ctr[host] += 1
            pmax_thr = int(self.aqm_pmax_thr[host])
            if pmax_thr > 0:
                backlog = max(int(self.tx_free[host]) - now, 0)
                span = int(self.aqm_span_ns[host])
                delta = min(max(backlog - int(self.aqm_min_ns[host]), 0), span)
                if delta >= span:
                    thr = 1 << 32  # ≥ max threshold: certain drop
                else:
                    thr = (pmax_thr * ((delta << 16) // span)) >> 16
                if int(self.eng.draws.bits(R_AQM, host, ctr)) < thr:
                    self.eng.metrics["nic_aqm_drops"] += 1
                    return None
        if self.has_tx_qlen and (int(self.tx_free[host]) - now) > int(self.tx_qlen_ns[host]):
            self.eng.metrics["nic_tx_drops"] += 1
            self.eng._link_nic_drop(host, dst)
            return None
        depart = max(now, int(self.tx_free[host]))
        self.tx_free[host] = depart + ser_delay_ns(wire, int(self.eng.exp.bw_up[host]))
        self.tx_bytes[host] += wire
        return depart

    def emit(self, h, s, flags, seq, length, mend, mmeta, now):
        k = self.socks[h][s]
        p = (
            h,
            s | (k.peer_sock << 8) | (flags << 16),
            seq,
            k.rcv_nxt,
            length,
            self.pr.rcvbuf,
            mend,
            mmeta,
            0,
            0,
        )
        depart = self._tx(h, length + WIRE_OVERHEAD, now, k.peer_host)
        if depart is None:  # queue-dropped: behaves like loss, rtx recovers
            return
        self.eng.send(h, k.peer_host, K_PKT, depart, p, now=now)

    def udp_send(self, h, dst_host, dst_sock, length, meta, meta2, now):
        p = (h, (dst_sock << 8) | (F_DGRAM << 16), 0, 0, length, 0, 0, meta, meta2, 0)
        depart = self._tx(h, length + WIRE_OVERHEAD, now, dst_host)
        if depart is None:
            return
        self.eng.send(h, dst_host, K_PKT, depart, p, now=now)

    # ------------------------------------------------------------------
    # TCP sender machinery (mirror of tcp.py tcp_flush/_ack_now)
    # ------------------------------------------------------------------
    def flush(self, h, s, now):
        pr = self.pr
        k = self.socks[h][s]
        for _ in range(pr.send_burst):
            total_end = seq_add(k.app_end, k.fin_pend)
            pending = seq_lt(k.snd_nxt, total_end)
            flight = seq_sub(k.snd_nxt, k.snd_una)
            limit = min(k.cwnd, k.peer_wnd)
            can = (
                k.st in SENDABLE
                and pending
                and flight < limit
                and self.eng.outbox_space(h, now) > 0
            )
            if not can:
                break
            if k.snd_nxt == 0:
                flags, length = (F_SYN | F_ACK if k.st == TCP_SYN_RCVD else F_SYN), 0
                seg_syn, seg_fin = True, False
            elif k.snd_nxt == k.app_end and k.fin_pend:
                flags, length = F_FIN | F_ACK, 0
                seg_syn, seg_fin = False, True
            else:
                flags = F_ACK
                length = min(pr.mss, seq_sub(k.app_end, k.snd_nxt), limit - flight)
                seg_syn, seg_fin = False, False
            mend = mmeta = 0
            if not seg_syn and not seg_fin:
                # Message-framed segmentation (mirror of tcp.py): truncate at
                # the first boundary in range so one segment = one message end.
                seg_hi = seq_add(k.snd_nxt, length)
                best = None
                for end, meta in k.mq:
                    if seq_lt(k.snd_nxt, end) and seq_le(end, seg_hi):
                        d = seq_sub(end, k.snd_nxt)
                        if best is None or d < best[0]:
                            best = (d, end, meta)
                if best is not None:
                    mend, mmeta = best[1], best[2]
                    length = best[0]
            self.emit(h, s, flags, k.snd_nxt, length, mend, mmeta, now)
            k.snd_nxt = seq_add(k.snd_nxt, length + (1 if (seg_syn or seg_fin) else 0))
            if seq_lt(k.snd_max, k.snd_nxt):
                k.snd_max = k.snd_nxt
            if not k.ts_act:
                k.ts_act = True
                k.ts_seq = k.snd_nxt
                k.ts_time = now
            if k.rtx_t == 0:
                k.rtx_t = now + k.rto
                if not k.timer_armed:
                    k.timer_armed = True
                    self.eng.schedule_local(h, now + k.rto, K_TCP_TIMER, (s,))
        # TX_RESUME if still pending (mirror ordering: checked after the burst).
        total_end = seq_add(k.app_end, k.fin_pend)
        pending = seq_lt(k.snd_nxt, total_end)
        wnd_ok = seq_sub(k.snd_nxt, k.snd_una) < min(k.cwnd, k.peer_wnd)
        blocked_outbox = self.eng.outbox_space(h, now) <= 0
        if k.st in SENDABLE and pending and wnd_ok and not k.txr:
            k.txr = 1
            t_resume = (now // self.eng.window + 1) * self.eng.window if blocked_outbox else now
            self.eng.schedule_local(h, t_resume, K_TX_RESUME, (s,))

    def ack_now(self, h, s, now):
        if self.eng.outbox_space(h, now) > 0:
            k = self.socks[h][s]
            self.emit(h, s, F_ACK, k.snd_nxt, 0, 0, 0, now)

    # ------------------------------------------------------------------
    # App-facing API (mirror of tcp.py tcp_listen/connect/send/close)
    # ------------------------------------------------------------------
    def listen(self, h, s):
        self.socks[h][s].st = TCP_LISTEN

    def connect(self, h, s, dst_host, dst_sock, now):
        self.socks[h][s].init_conn(self.pr, dst_host, dst_sock, TCP_SYN_SENT, 0)
        self.flush(h, s, now)

    def tcp_send(self, h, s, nbytes, meta, now) -> int:
        pr = self.pr
        k = self.socks[h][s]
        buffered = seq_sub(k.app_end, k.snd_una) - (1 if k.snd_una == 0 else 0)
        space = max(pr.sndbuf - buffered, 0)
        accepted = max(0, min(nbytes, space))
        if accepted > 0:
            k.app_end = seq_add(k.app_end, accepted)
            if accepted == nbytes and meta != 0 and len(k.mq) < pr.msgq_cap:
                k.mq.append((k.app_end, meta))
            self.flush(h, s, now)
        return accepted

    def close(self, h, s, now):
        k = self.socks[h][s]
        if k.st == TCP_ESTABLISHED:
            k.st = TCP_FIN_WAIT_1
        elif k.st == TCP_CLOSE_WAIT:
            k.st = TCP_LAST_ACK
        else:
            return
        k.fin_pend = 1
        self.flush(h, s, now)

    # ------------------------------------------------------------------
    # Event dispatch
    # ------------------------------------------------------------------
    def handle(self, host, time, kind, p):
        if kind == K_PKT:
            # Only the rx-drop-tail path reaches here (rx_batch otherwise
            # short-circuits in CpuEngine.run before event accounting).
            wire = p[4] + WIRE_OVERHEAD
            if self.has_rx_qlen and (int(self.rx_free[host]) - time) > int(self.rx_qlen_ns[host]):
                self.eng.metrics["nic_rx_drops"] += 1  # downlink drop-tail
                return
            ready = max(time, int(self.rx_free[host]))
            self.rx_free[host] = ready + ser_delay_ns(wire, int(self.eng.exp.bw_dn[host]))
            self.rx_bytes[host] += wire
            self.eng.schedule_local(host, ready, K_PKT_DELIVER, p)
        elif kind == K_PKT_DELIVER:
            flags = (p[1] >> 16) & 0xFF
            if flags & F_DGRAM:
                self.app.on_notify(
                    host, (p[1] >> 8) & 0xFF, N_DGRAM, p[7], p[8], p[4], 0, time
                )
            else:
                self.tcp_rx(host, p, time)
        elif kind == K_TCP_TIMER:
            self.tcp_timer(host, p[0], time)
        elif kind == K_TX_RESUME:
            s = p[0]
            self.socks[host][s].txr = 0
            self.flush(host, s, time)
        elif kind == K_APP:
            self.app.on_wakeup(host, time, p)

    # ------------------------------------------------------------------
    # TCP receive path (mirror of tcp.py tcp_rx, same sequencing)
    # ------------------------------------------------------------------
    def tcp_rx(self, h, p, now):
        pr = self.pr
        src, packed, seq, ackno, length, wnd, mend, mmeta = p[:8]
        ss = packed & 0xFF
        ds = (packed >> 8) & 0xFF
        flags = (packed >> 16) & 0xFF
        is_syn = bool(flags & F_SYN)
        is_ack = bool(flags & F_ACK)
        is_fin = bool(flags & F_FIN)
        socks = self.socks[h]
        k = socks[ds]
        notifs = 0
        n_meta = n_meta2 = n_dlen = n_space = 0
        n_sock = ds

        # passive open
        if is_syn and not is_ack and k.st == TCP_LISTEN:
            dup = any(
                c.peer_host == src and c.peer_sock == ss
                and c.st not in (TCP_FREE, TCP_LISTEN)
                for c in socks
            )
            # Highest free slot (mirror of tcp.py: low slots are app-owned).
            child = next(
                (i for i in range(len(socks) - 1, -1, -1) if socks[i].st == TCP_FREE),
                None,
            )
            if not dup and child is not None:
                socks[child].init_conn(pr, src, ss, TCP_SYN_RCVD, 1)
                socks[child].peer_wnd = wnd
                self.flush(h, child, now)
            return

        learn_peer = k.st == TCP_SYN_SENT and is_syn and is_ack
        v = (
            k.st in CONN_STATES
            and k.peer_host == src
            and (k.peer_sock == ss or learn_peer)
        )
        if not v:
            return
        if learn_peer:
            k.peer_sock = ss
        if is_ack:
            k.peer_wnd = max(wnd, 1)

        state = k.st  # pre-transition snapshot (mirrors the vector code)
        snd_una0, snd_nxt0 = k.snd_una, k.snd_nxt
        snd_max0 = k.snd_max
        a = is_ack
        # Acceptance tests against snd_max (highest ever sent), NOT the
        # possibly-rewound snd_nxt — mirror of tcp.py (outage deadlock).
        new_ack = a and seq_lt(snd_una0, ackno) and seq_le(ackno, snd_max0)
        est_ss = a and is_syn and state == TCP_SYN_SENT and ackno == 1
        frx = False
        if new_ack:
            if k.ts_act and seq_le(k.ts_seq, ackno):
                rtt = max(now - k.ts_time, 1)
                if k.srtt == 0:
                    k.srtt, k.rttvar = rtt, rtt // 2
                else:
                    err = rtt - k.srtt
                    k.srtt = k.srtt + (err >> 3)
                    k.rttvar = k.rttvar + ((abs(err) - k.rttvar) >> 2)
                k.rto = min(max(k.srtt + max(4 * k.rttvar, 1_000_000), pr.rto_min), pr.rto_max)
                k.ts_act = False
            grow = pr.mss if k.cwnd < k.ssthresh else max((pr.mss * pr.mss) // max(k.cwnd, 1), 1)
            k.cwnd = min(k.cwnd + grow, CWND_MAX)
            k.snd_una = ackno
            if seq_lt(k.snd_nxt, ackno):
                k.snd_nxt = ackno  # acked bytes were sent pre-rewind
            k.dupacks = 0
            k.mq = [(e, m) for (e, m) in k.mq if seq_lt(ackno, e)]
            outstanding = seq_lt(ackno, snd_max0)
            k.rtx_t = (now + k.rto) if outstanding else 0
            if state == TCP_SYN_RCVD:
                k.st = TCP_ESTABLISHED
                notifs |= N_ACCEPTED
        if est_ss:
            k.st = TCP_ESTABLISHED
            k.rcv_nxt = 1
            notifs |= N_ESTABLISHED
        if new_ack:
            total_end = seq_add(k.app_end, k.fin_pend)
            fin_acked = k.fin_pend == 1 and ackno == total_end
            closed_by_ack = False
            if fin_acked and state == TCP_FIN_WAIT_1:
                k.st = TCP_FIN_WAIT_2
            if fin_acked and state in (TCP_CLOSING, TCP_LAST_ACK):
                closed_by_ack = True
                notifs |= N_CLOSED
            if state in (TCP_ESTABLISHED, TCP_CLOSE_WAIT) and not closed_by_ack:
                notifs |= N_SPACE
                n_space = pr.sndbuf - seq_sub(k.app_end, ackno)
        else:
            closed_by_ack = False
        dup_a = (
            a and not new_ack and ackno == snd_una0 and seq_lt(ackno, snd_max0)
            and length == 0 and not is_syn and not is_fin
        )
        if dup_a:
            k.dupacks += 1
            if k.dupacks == pr.dupack_thresh and seq_le(k.recover, snd_una0):
                frx = True
                flight = seq_sub(snd_nxt0, snd_una0)
                k.ssthresh = max(flight // 2, 2 * pr.mss)
                k.cwnd = k.ssthresh
                k.recover = snd_nxt0
                k.snd_nxt = snd_una0
                k.ts_act = False
                self.eng.metrics["tcp_fast_rtx"] += 1
        if new_ack or frx:
            self.flush(h, ds, now)

        # payload + FIN
        state2 = k.st
        can_rcv = state2 in RCV_STATES
        has_data = can_rcv and length > 0
        in_order = has_data and seq == k.rcv_nxt
        if in_order:
            k.rcv_nxt = seq_add(k.rcv_nxt, length)
            notifs |= N_DATA
            n_dlen = length
            if mend != 0:
                notifs |= N_MSG
                n_meta = mmeta
        elif has_data:
            self.eng.metrics["tcp_ooo_drops"] += 1
        fin_here = (
            is_fin
            and seq_add(seq, length) == k.rcv_nxt
            and state2 in (TCP_ESTABLISHED, TCP_FIN_WAIT_1, TCP_FIN_WAIT_2)
        )
        closed_by_fin = False
        if fin_here:
            k.rcv_nxt = seq_add(k.rcv_nxt, 1)
            if state2 == TCP_ESTABLISHED:
                k.st = TCP_CLOSE_WAIT
                notifs |= N_PEER_FIN
            elif state2 == TCP_FIN_WAIT_1:
                k.st = TCP_CLOSING
            elif state2 == TCP_FIN_WAIT_2:
                closed_by_fin = True
                notifs |= N_CLOSED
        if closed_by_ack or closed_by_fin:
            k.st = TCP_FREE
            k.rtx_t = 0
        if has_data or is_fin or est_ss:
            self.ack_now(h, ds, now)
        if notifs:
            self.app.on_notify(h, n_sock, notifs, n_meta, n_meta2, n_dlen, n_space, now)

    def tcp_timer(self, h, s, now):
        pr = self.pr
        k = self.socks[h][s]
        k.timer_armed = False
        if k.rtx_t == 0:
            return
        if now < k.rtx_t:
            k.timer_armed = True
            self.eng.schedule_local(h, k.rtx_t, K_TCP_TIMER, (s,))
            return
        outstanding = seq_lt(k.snd_una, k.snd_max)
        if outstanding and k.st in SENDABLE:
            flight = seq_sub(k.snd_nxt, k.snd_una)
            k.ssthresh = max(flight // 2, 2 * pr.mss)
            k.cwnd = pr.mss
            k.rto = min(k.rto * 2, pr.rto_max)
            k.snd_nxt = k.snd_una
            k.ts_act = False
            k.dupacks = 0
            k.recover = k.snd_una
            k.rtx_t = now + k.rto
            k.timer_armed = True
            self.eng.metrics["tcp_rto"] += 1
            self.eng.schedule_local(h, k.rtx_t, K_TCP_TIMER, (s,))
            self.flush(h, s, now)
        else:
            k.rtx_t = 0

    def summary(self) -> dict[str, Any]:
        d = {
            "nic_tx_bytes": self.tx_bytes,
            "nic_rx_bytes": self.rx_bytes,
        }
        d.update(self.app.summary())
        return d


# --------------------------------------------------------------------------
# App mirrors
# --------------------------------------------------------------------------
class CpuFilexfer:
    """Mirror of shadow1_tpu_torch/apps/filexfer.py."""

    FLOW_DONE = 1
    OP_START = 1

    def __init__(self, model: CpuNetModel):
        self.m = model
        cfg = model.eng.exp.model_cfg
        h = model.n_hosts
        self.role = np.asarray(cfg["role"], np.int32)
        self.server = np.asarray(cfg["server"], np.int32)
        self.flow_bytes = np.asarray(cfg["flow_bytes"], np.int32)
        self.start_time = np.asarray(cfg["start_time"], np.int64)
        self.flows_left = np.asarray(cfg["flow_count"], np.int32).copy()
        self.remaining = np.zeros(h, np.int32)
        self.closed_sent = np.zeros(h, bool)
        self.rx_bytes = np.zeros(h, np.int64)
        self.flows_done = np.zeros(h, np.int32)
        self.done_time = np.zeros(h, np.int64)

    def start(self):
        for h in range(self.m.n_hosts):
            if self.role[h] == 0:
                self.m.listen(h, 0)
            elif self.role[h] == 1:
                self.m.eng.schedule_local(h, int(self.start_time[h]), K_APP, (self.OP_START,))

    def _client_start(self, h, now):
        self.remaining[h] = self.flow_bytes[h]
        self.closed_sent[h] = False
        self.m.connect(h, 0, int(self.server[h]), 0, now)

    def _client_pump(self, h, now):
        if self.remaining[h] > 0:
            accepted = self.m.tcp_send(h, 0, int(self.remaining[h]), self.FLOW_DONE, now)
            self.remaining[h] -= accepted
        # Zero-byte flows close right at establishment (mirror of filexfer.py).
        if self.remaining[h] == 0 and not self.closed_sent[h]:
            self.closed_sent[h] = True
            self.m.close(h, 0, now)

    def on_wakeup(self, h, now, p):
        if p[0] == self.OP_START:
            self._client_start(h, now)

    def on_notify(self, h, sock, flags, meta, meta2, dlen, space, now):
        if self.role[h] == 1:
            if flags & (N_ESTABLISHED | N_SPACE):
                self._client_pump(h, now)
        if self.role[h] == 0:
            if flags & N_DATA:
                self.rx_bytes[h] += dlen
            if (flags & N_MSG) and meta == self.FLOW_DONE:
                self.flows_done[h] += 1
            if flags & N_PEER_FIN:
                self.m.close(h, sock, now)
        if self.role[h] == 1 and (flags & N_CLOSED):
            self.flows_left[h] -= 1
            if self.flows_left[h] > 0:
                self._client_start(h, now)
            else:
                self.done_time[h] = now

    def summary(self):
        return {
            "rx_bytes": self.rx_bytes,
            "flows_done": self.flows_done,
            "done_time": self.done_time,
            "total_rx_bytes": int(self.rx_bytes.sum()),
            "total_flows_done": int(self.flows_done.sum()),
        }


class CpuDgram:
    """Mirror of shadow1_tpu_torch/apps/dgram.py."""

    OP_TICK = 1

    def __init__(self, model: CpuNetModel):
        self.m = model
        cfg = model.eng.exp.model_cfg
        h = model.n_hosts
        self.dst = np.asarray(cfg["dst"], np.int32)
        self.payload = np.asarray(cfg["payload"], np.int32)
        self.interval = np.asarray(cfg["interval"], np.int64)
        self.left = np.asarray(cfg["count"], np.int32).copy()
        self.start_time = np.asarray(cfg["start_time"], np.int64)
        self.rx_count = np.zeros(h, np.int64)
        self.rx_bytes = np.zeros(h, np.int64)

    def start(self):
        for h in range(self.m.n_hosts):
            if self.left[h] > 0:
                self.m.eng.schedule_local(h, int(self.start_time[h]), K_APP, (self.OP_TICK,))

    def on_wakeup(self, h, now, p):
        if p[0] != self.OP_TICK or self.left[h] <= 0:
            return
        self.m.udp_send(h, int(self.dst[h]), 0, int(self.payload[h]), 1, 0, now)
        self.left[h] -= 1
        if self.left[h] > 0:
            self.m.eng.schedule_local(h, now + int(self.interval[h]), K_APP, (self.OP_TICK,))

    def on_notify(self, h, sock, flags, meta, meta2, dlen, space, now):
        if flags & N_DGRAM:
            self.rx_count[h] += 1
            self.rx_bytes[h] += dlen

    def summary(self):
        return {
            "rx_count": self.rx_count,
            "rx_bytes": self.rx_bytes,
            "total_rx": int(self.rx_count.sum()),
        }

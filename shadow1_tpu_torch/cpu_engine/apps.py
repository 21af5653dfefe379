"""CPU oracle mirrors of the model applications (tgen / tor / bitcoin).

Per-host object implementations of exactly the semantics in
shadow1_tpu_torch/apps/*.py — same draw keys, same operation order, same integer
arithmetic — so event streams match the batched engine bit-for-bit. These
play the role of the reference's real plugin binaries (shadow-plugin-tgen /
-tor / -bitcoin) in the sanctioned model-application substitution
(SURVEY §2.4).
"""

from __future__ import annotations

import numpy as np

from shadow1_tpu_torch.consts import (
    K_APP,
    N_ACCEPTED,
    N_CLOSED,
    N_DATA,
    N_ESTABLISHED,
    N_MSG,
    N_PEER_FIN,
    N_SPACE,
    R_APP,
)

# Mirrors of apps/tgen.py constants.
TGEN_STREAM_DONE = 1
TGEN_OP_START = 1
TGEN_SIZE_MAX = 1 << 30


class CpuTgen:
    """Mirror of shadow1_tpu_torch/apps/tgen.py."""

    def __init__(self, model):
        self.m = model
        cfg = model.eng.exp.model_cfg
        h = model.n_hosts
        self.active = np.asarray(cfg["active"], np.int32)
        self.streams_left = np.asarray(cfg["streams"], np.int32).copy()
        self.mean_bytes = np.asarray(cfg["mean_bytes"], np.float64)
        self.mean_think = np.asarray(cfg["mean_think_ns"], np.float64)
        self.start_time = np.asarray(cfg["start_time"], np.int64)
        self.fixed_size = bool(cfg.get("fixed_size"))
        self.remaining = np.zeros(h, np.int64)
        self.closed_sent = np.zeros(h, bool)
        self.ctr = np.zeros(h, np.int64)
        self.rx_bytes = np.zeros(h, np.int64)
        self.streams_served = np.zeros(h, np.int32)
        self.streams_done = np.zeros(h, np.int32)
        self.done_time = np.zeros(h, np.int64)

    def start(self):
        for h in range(self.m.n_hosts):
            self.m.listen(h, 0)
            if self.active[h] == 1 and self.streams_left[h] > 0:
                self.m.eng.schedule_local(
                    h, int(self.start_time[h]), K_APP, (TGEN_OP_START,)
                )

    def _start_stream(self, h, now):
        d = self.m.eng.draws
        c = int(self.ctr[h])
        raw = d.randint(R_APP, h, 3 * c + 0, self.m.eng.exp.n_hosts - 1)
        dst = raw + (1 if raw >= h else 0)
        if self.fixed_size:
            size = max(int(self.mean_bytes[h]), 1)
        else:
            size = min(
                max(d.exponential_ns(R_APP, h, 3 * c + 1, float(self.mean_bytes[h])), 1),
                TGEN_SIZE_MAX,
            )
        self.remaining[h] = size
        self.closed_sent[h] = False
        self.ctr[h] += 1
        self.m.connect(h, 1, dst, 0, now)

    def _client_pump(self, h, now):
        if self.remaining[h] > 0:
            acc = self.m.tcp_send(h, 1, int(self.remaining[h]), TGEN_STREAM_DONE, now)
            self.remaining[h] -= acc
        if self.remaining[h] == 0 and not self.closed_sent[h]:
            self.closed_sent[h] = True
            self.m.close(h, 1, now)

    def on_wakeup(self, h, now, p):
        if p[0] == TGEN_OP_START:
            self._start_stream(h, now)

    def on_notify(self, h, sock, flags, meta, meta2, dlen, space, now):
        if sock == 1:
            if flags & (N_ESTABLISHED | N_SPACE):
                self._client_pump(h, now)
            if flags & N_CLOSED:
                self.streams_left[h] -= 1
                self.streams_done[h] += 1
                c = int(self.ctr[h]) - 1
                if self.streams_left[h] > 0:
                    think = self.m.eng.draws.exponential_ns(
                        R_APP, h, 3 * c + 2, float(self.mean_think[h])
                    )
                    self.m.eng.schedule_local(h, now + think, K_APP, (TGEN_OP_START,))
                else:
                    self.done_time[h] = now
        else:
            if flags & N_DATA:
                self.rx_bytes[h] += dlen
            if (flags & N_MSG) and meta == TGEN_STREAM_DONE:
                self.streams_served[h] += 1
            if flags & N_PEER_FIN:
                self.m.close(h, sock, now)

    def summary(self):
        return {
            "rx_bytes": self.rx_bytes,
            "streams_served": self.streams_served,
            "streams_done": self.streams_done,
            "done_time": self.done_time,
            "total_rx_bytes": int(self.rx_bytes.sum()),
            "total_streams_served": int(self.streams_served.sum()),
            "total_streams_done": int(self.streams_done.sum()),
        }


# --------------------------------------------------------------------------
# bitcoin (mirror of shadow1_tpu_torch/apps/bitcoin.py)
# --------------------------------------------------------------------------
BTC_OP_CONNECT_ONE = 1
BTC_OP_TX_CREATE = 2
BTC_OP_TX_MSG = 3
BTC_CMD_INV = 1
BTC_CMD_GET = 2
BTC_CMD_TX = 3
BTC_TXID_BITS = 20
BTC_TXID_MASK = (1 << BTC_TXID_BITS) - 1


class CpuBitcoin:
    """Mirror of shadow1_tpu_torch/apps/bitcoin.py (including its event-deferred
    fan-out: dials and announcements are self-scheduled one-conn events)."""

    def __init__(self, model):
        self.m = model
        cfg = model.eng.exp.model_cfg
        self.peers = np.asarray(cfg["peers"], np.int32)
        self.tx_origin = np.asarray(cfg["tx_origin"], np.int64)
        self.tx_time = np.asarray(cfg["tx_time"], np.int64)
        self.tx_size = int(cfg.get("tx_size", 400))
        self.inv_size = int(cfg.get("inv_size", 36))
        self.connect_time = int(cfg.get("connect_time", 0))
        h = model.n_hosts
        n_tx = len(self.tx_origin)
        self.nbr_sock = np.full(self.peers.shape, -1, np.int32)
        self.seen = np.zeros((h, n_tx), bool)
        self.req = np.zeros((h, n_tx), bool)
        self.seen_time = np.zeros((h, n_tx), np.int64)
        self.tx_rx = np.zeros(h, np.int64)
        self.msg_retries = np.zeros(h, np.int64)

    @staticmethod
    def _meta(cmd, txid):
        return (cmd << BTC_TXID_BITS) | txid

    def _push_msg(self, h, sock, meta, nbytes, now):
        self.m.eng.schedule_local(h, now, K_APP, (BTC_OP_TX_MSG, sock, meta, nbytes))

    def start(self):
        # Push order mirrors apps/bitcoin.py init: per host, one
        # OP_CONNECT_ONE per outbound slot (j ascending), then that host's
        # tx creations in tx order.
        for h in range(self.m.n_hosts):
            self.m.listen(h, 0)
        for j in range(self.peers.shape[1]):
            for h in range(self.m.n_hosts):
                if self.peers[h, j] > h:
                    self.m.eng.schedule_local(
                        h, self.connect_time, K_APP, (BTC_OP_CONNECT_ONE, j)
                    )
        for t in range(len(self.tx_origin)):
            self.m.eng.schedule_local(
                int(self.tx_origin[t]), int(self.tx_time[t]), K_APP,
                (BTC_OP_TX_CREATE, t),
            )

    def _announce(self, h, txid, skip_sock, now):
        for j in range(self.peers.shape[1]):
            ns = int(self.nbr_sock[h, j])
            if ns >= 0 and ns != skip_sock:
                self._push_msg(h, ns, self._meta(BTC_CMD_INV, txid), self.inv_size, now)

    def _mark_seen(self, h, txid, now) -> bool:
        if self.seen[h, txid]:
            return False
        self.seen[h, txid] = True
        self.seen_time[h, txid] = now
        return True

    def on_wakeup(self, h, now, p):
        if p[0] == BTC_OP_CONNECT_ONE:
            j = p[1]
            self.nbr_sock[h, j] = 1 + j
            self.m.connect(h, 1 + j, int(self.peers[h, j]), 0, now)
        elif p[0] == BTC_OP_TX_CREATE:
            t = p[1]
            if self._mark_seen(h, t, now):
                self._announce(h, t, -1, now)
        elif p[0] == BTC_OP_TX_MSG:
            # Admission-checked send (mirror of bitcoin.py OP_TX_MSG).
            _op, sock, meta, nbytes = p
            k = self.m.socks[h][sock]
            from shadow1_tpu_torch.consts import seq_sub
            buffered = seq_sub(k.app_end, k.snd_una) - (1 if k.snd_una == 0 else 0)
            fits = (self.m.pr.sndbuf - buffered) >= nbytes
            mq_ok = len(k.mq) < self.m.pr.msgq_cap
            if fits and mq_ok:
                self.m.tcp_send(h, sock, nbytes, meta, now)
            else:
                self.msg_retries[h] += 1
                t_retry = (now // self.m.eng.window + 1) * self.m.eng.window
                self.m.eng.schedule_local(h, t_retry, K_APP, p)

    def on_notify(self, h, sock, flags, meta, meta2, dlen, space, now):
        if flags & N_ACCEPTED:
            peer = self.m.socks[h][sock].peer_host
            for j in range(self.peers.shape[1]):
                if self.peers[h, j] == peer and self.nbr_sock[h, j] < 0:
                    self.nbr_sock[h, j] = sock
        if flags & N_MSG:
            cmd = meta >> BTC_TXID_BITS
            txid = meta & BTC_TXID_MASK
            if cmd == BTC_CMD_INV and not self.seen[h, txid] and not self.req[h, txid]:
                self.req[h, txid] = True
                self._push_msg(h, sock, self._meta(BTC_CMD_GET, txid), self.inv_size, now)
            elif cmd == BTC_CMD_GET and self.seen[h, txid]:
                self._push_msg(h, sock, self._meta(BTC_CMD_TX, txid), self.tx_size, now)
            elif cmd == BTC_CMD_TX:
                self.tx_rx[h] += 1
                if self._mark_seen(h, txid, now):
                    self._announce(h, txid, sock, now)

    def summary(self):
        return {
            "seen": self.seen,
            "seen_time": self.seen_time,
            "tx_rx": self.tx_rx,
            "reach": self.seen.sum(axis=0),
            "msg_retries": self.msg_retries,
            "total_seen": int(self.seen.sum()),
            "total_tx_rx": int(self.tx_rx.sum()),
        }


# --------------------------------------------------------------------------
# tor (mirror of shadow1_tpu_torch/apps/tor.py)
# --------------------------------------------------------------------------
TOR_CELL = 512
TOR_C_CREATE = 1
TOR_C_CREATED = 2
TOR_C_EXTEND = 3
TOR_C_EXTENDED = 4
TOR_C_BEGIN = 5
TOR_C_DATA = 6
TOR_C_END = 7
TOR_C_DIRREQ = 8
TOR_C_DIRRESP = 9
TOR_OP_START = 1
TOR_OP_TX_CELL = 2
TOR_OP_CONNECT_RELAY = 3
TOR_OP_DRAIN = 4
TOR_OP_THINK = 5
TOR_CL_DIR_CONN = 1
TOR_CL_DIR_FETCH = 2
TOR_CL_GUARD_CONN = 3
TOR_CL_BUILDING = 4
TOR_CL_STREAM = 5
TOR_CL_DONE = 7


class CpuTor:
    """Mirror of shadow1_tpu_torch/apps/tor.py (same draws, same push order)."""

    def __init__(self, model):
        from shadow1_tpu_torch.apps.tor import _build_tables
        from shadow1_tpu_torch.consts import R_TOR_PATH

        self.m = model
        self.R = R_TOR_PATH
        cfg = model.eng.exp.model_cfg
        self.cfg = cfg
        self.t = _build_tables(cfg)
        h = model.n_hosts
        self.role = np.asarray(cfg["role"], np.int32)
        self.n_streams_cfg = np.asarray(cfg["n_streams"], np.int32)
        self.mean_cells = np.asarray(cfg["mean_stream_cells"], np.float64)
        self.mean_think = np.asarray(cfg["mean_think_ns"], np.float64)
        self.start_time = np.asarray(cfg["start_time"], np.int64)
        self.consensus_bytes = int(cfg.get("consensus_bytes", 2048))
        self.cells_max = int(cfg.get("cells_max", 120))
        ct = int(cfg.get("ct_cap", 64))
        s = model.pr.sockets_per_host
        self.cl_state = np.zeros(h, np.int32)
        self.cl_guard = np.full(h, -1, np.int32)
        self.cl_circ = np.zeros(h, np.int32)
        self.cl_hop = np.zeros(h, np.int32)
        self.cl_mid = np.zeros(h, np.int32)
        self.cl_exit = np.zeros(h, np.int32)
        self.cl_circs_left = np.asarray(cfg["n_circuits"], np.int32).copy()
        self.cl_streams_left = np.zeros(h, np.int32)
        self.cl_cells_want = np.zeros(h, np.int32)
        self.ctr = np.zeros(h, np.int64)
        self.streams_done = np.zeros(h, np.int32)
        self.cells_rx = np.zeros(h, np.int64)
        self.bootstrap_time = np.zeros(h, np.int64)
        self.done_time = np.zeros(h, np.int64)
        self.rc_peer = np.full((h, s), -1, np.int32)
        self.rc_next_circ = np.ones((h, s), np.int32)
        self.ct_used = np.zeros((h, ct), bool)
        self.ct_in_sock = np.zeros((h, ct), np.int32)
        self.ct_in_circ = np.zeros((h, ct), np.int32)
        self.ct_out_sock = np.full((h, ct), -1, np.int32)
        self.ct_out_circ = np.zeros((h, ct), np.int32)
        self.ct_pend = np.zeros((h, ct), bool)
        self.cells_fwd = np.zeros(h, np.int64)
        self.ct_overflow = np.zeros(h, np.int64)
        self.cell_retries = np.zeros(h, np.int64)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _meta(circ, aux, cmd):
        return (int(circ) << 18) | (int(aux) << 4) | cmd

    @staticmethod
    def _decode(meta):
        return meta >> 18, (meta >> 4) & 0x3FFF, meta & 0xF

    def _draw(self, h):
        c = int(self.ctr[h])
        self.ctr[h] += 1
        return c

    def _pick_weighted(self, h, ids, cum):
        u = self.m.eng.draws.randint(self.R, h, self._draw(h), int(cum[-1]))
        idx = int(np.searchsorted(cum, u, side="right"))
        return int(ids[min(idx, len(ids) - 1)])

    def _push_cell(self, h, sock, meta, nbytes, now):
        self.m.eng.schedule_local(h, now, K_APP, (TOR_OP_TX_CELL, sock, meta, nbytes))

    # -- client steps ------------------------------------------------------
    def _begin_circuit(self, h, now):
        self.cl_mid[h] = self._pick_weighted(h, self.t["relay_ids"], self.t["relay_cum"])
        self.cl_exit[h] = self._pick_weighted(h, self.t["exit_ids"], self.t["exit_cum"])
        self.cl_circ[h] += 1
        self.cl_hop[h] = 1
        self.cl_state[h] = TOR_CL_BUILDING
        self.cl_streams_left[h] = self.n_streams_cfg[h]
        self._push_cell(h, 1, self._meta(self.cl_circ[h], 0, TOR_C_CREATE), TOR_CELL, now)

    def _begin_stream(self, h, now):
        want = min(max(self.m.eng.draws.exponential_ns(
            self.R, h, self._draw(h), float(self.mean_cells[h])), 1), self.cells_max)
        self.cl_cells_want[h] = want
        self.cl_state[h] = TOR_CL_STREAM
        self._push_cell(h, 1, self._meta(self.cl_circ[h], want, TOR_C_BEGIN), TOR_CELL, now)

    def _think(self, h, now):
        think = self.m.eng.draws.exponential_ns(
            self.R, h, self._draw(h), float(self.mean_think[h])
        )
        self.m.eng.schedule_local(h, now + think, K_APP, (TOR_OP_THINK,))

    # -- wakeups -----------------------------------------------------------
    def start(self):
        for h in range(self.m.n_hosts):
            if self.role[h] in (0, 2):
                self.m.listen(h, 0)
            if self.role[h] == 1 and self.cl_circs_left[h] > 0:
                self.m.eng.schedule_local(h, int(self.start_time[h]), K_APP, (TOR_OP_START,))

    def on_wakeup(self, h, now, p):
        if p[0] == TOR_OP_START:
            d_idx = self.m.eng.draws.randint(self.R, h, self._draw(h), len(self.t["dir_ids"]))
            self.cl_state[h] = TOR_CL_DIR_CONN
            self.m.connect(h, 2, int(self.t["dir_ids"][d_idx]), 0, now)
        elif p[0] == TOR_OP_TX_CELL:
            _op, sock, meta, nbytes = p
            k = self.m.socks[h][sock]
            from shadow1_tpu_torch.consts import seq_sub
            buffered = seq_sub(k.app_end, k.snd_una) - (1 if k.snd_una == 0 else 0)
            fits = (self.m.pr.sndbuf - buffered) >= nbytes
            mq_ok = len(k.mq) < self.m.pr.msgq_cap
            if fits and mq_ok:
                self.m.tcp_send(h, sock, nbytes, meta, now)
            else:
                self.cell_retries[h] += 1
                t_retry = (now // self.m.eng.window + 1) * self.m.eng.window
                self.m.eng.schedule_local(h, t_retry, K_APP, p)
        elif p[0] == TOR_OP_CONNECT_RELAY:
            self.m.connect(h, p[1], p[2], 0, now)
        elif p[0] == TOR_OP_DRAIN:
            sock = p[1]
            pend = [
                i for i in range(self.ct_used.shape[1])
                if self.ct_used[h, i] and self.ct_pend[h, i]
                and self.ct_out_sock[h, i] == sock
            ]
            if pend:
                i = pend[0]
                self.ct_pend[h, i] = False
                self._push_cell(
                    h, sock, self._meta(self.ct_out_circ[h, i], 0, TOR_C_CREATE),
                    TOR_CELL, now,
                )
                if len(pend) > 1:
                    self.m.eng.schedule_local(h, now, K_APP, (TOR_OP_DRAIN, sock))
        elif p[0] == TOR_OP_THINK:
            if self.cl_streams_left[h] > 0:
                self._begin_stream(h, now)
            elif self.cl_circs_left[h] > 0:
                self._begin_circuit(h, now)

    # -- notifications -----------------------------------------------------
    def on_notify(self, h, sock, flags, meta, meta2, dlen, space, now):
        role = self.role[h]
        est = bool(flags & N_ESTABLISHED)
        msg = bool(flags & N_MSG)
        circ, aux, cmd = self._decode(meta)

        if role == 1:
            if est and sock == 2 and self.cl_state[h] == TOR_CL_DIR_CONN:
                self.cl_state[h] = TOR_CL_DIR_FETCH
                self._push_cell(h, 2, self._meta(0, 0, TOR_C_DIRREQ), TOR_CELL, now)
            if msg and sock == 2 and cmd == TOR_C_DIRRESP and self.cl_state[h] == TOR_CL_DIR_FETCH:
                self.cl_guard[h] = self._pick_weighted(h, self.t["guard_ids"], self.t["guard_cum"])
                self.bootstrap_time[h] = now
                self.cl_state[h] = TOR_CL_GUARD_CONN
                self.m.close(h, 2, now)
                self.m.connect(h, 1, int(self.cl_guard[h]), 0, now)
            if est and sock == 1 and self.cl_state[h] == TOR_CL_GUARD_CONN:
                self._begin_circuit(h, now)
            if msg and sock == 1 and circ == self.cl_circ[h]:
                if cmd == TOR_C_CREATED and self.cl_hop[h] == 1:
                    self.cl_hop[h] = 2
                    self._push_cell(
                        h, 1, self._meta(circ, self.cl_mid[h], TOR_C_EXTEND), TOR_CELL, now
                    )
                elif cmd == TOR_C_EXTENDED and self.cl_hop[h] == 2:
                    self.cl_hop[h] = 3
                    self._push_cell(
                        h, 1, self._meta(circ, self.cl_exit[h], TOR_C_EXTEND), TOR_CELL, now
                    )
                elif cmd == TOR_C_EXTENDED and self.cl_hop[h] == 3:
                    self._begin_stream(h, now)
                elif cmd == TOR_C_DATA and self.cl_state[h] == TOR_CL_STREAM:
                    self.cells_rx[h] += aux
                elif cmd == TOR_C_END and self.cl_state[h] == TOR_CL_STREAM:
                    self.streams_done[h] += 1
                    self.cl_streams_left[h] -= 1
                    if self.cl_streams_left[h] == 0:
                        self.cl_circs_left[h] -= 1
                        if self.cl_circs_left[h] == 0:
                            self.done_time[h] = now
                            self.cl_state[h] = TOR_CL_DONE
                            return
                    self._think(h, now)
            return

        if role == 2:
            if msg and cmd == TOR_C_DIRREQ:
                self._push_cell(
                    h, sock, self._meta(0, 0, TOR_C_DIRRESP), self.consensus_bytes, now
                )
            if flags & N_PEER_FIN:
                self.m.close(h, sock, now)
            return

        if role != 0:
            return
        # Relay.
        if est and self.rc_peer[h, sock] >= 0:
            self.m.eng.schedule_local(h, now, K_APP, (TOR_OP_DRAIN, sock))
        if not msg:
            return
        self._relay_on_cell(h, sock, meta, now)

    def _relay_on_cell(self, h, sock, meta, now):
        circ, aux, cmd = self._decode(meta)
        ct = self.ct_used.shape[1]
        if cmd == TOR_C_CREATE:
            slot = next((i for i in range(ct) if not self.ct_used[h, i]), None)
            if slot is None:
                self.ct_overflow[h] += 1
                return
            self.ct_used[h, slot] = True
            self.ct_in_sock[h, slot] = sock
            self.ct_in_circ[h, slot] = circ
            self.ct_out_sock[h, slot] = -1
            self.ct_pend[h, slot] = False
            self._push_cell(h, sock, self._meta(circ, 0, TOR_C_CREATED), TOR_CELL, now)
            return
        # locate by in-side then out-side
        idx = from_in = from_out = None
        for i in range(ct):
            if self.ct_used[h, i] and self.ct_in_sock[h, i] == sock and self.ct_in_circ[h, i] == circ:
                idx, from_in = i, True
                break
        if idx is None:
            for i in range(ct):
                if self.ct_used[h, i] and self.ct_out_sock[h, i] == sock and self.ct_out_circ[h, i] == circ:
                    idx, from_out = i, True
                    break
        if idx is None:
            return
        from_in = bool(from_in)
        from_out = bool(from_out)

        if from_in and cmd == TOR_C_EXTEND and self.ct_out_sock[h, idx] < 0:
            target = aux
            r_sock = next(
                (s for s in range(self.rc_peer.shape[1]) if self.rc_peer[h, s] == target),
                None,
            )
            if r_sock is not None:
                osock = r_sock
            else:
                socks = self.m.socks[h]
                from shadow1_tpu_torch.consts import TCP_FREE as _FREE
                osock = next(
                    (s for s in range(1, len(socks)) if socks[s].st == _FREE), None
                )
                if osock is None:
                    self.ct_overflow[h] += 1
                    return
            ocirc = int(self.rc_next_circ[h, osock])
            self.rc_next_circ[h, osock] += 1
            if r_sock is None:
                self.rc_peer[h, osock] = target
            self.ct_out_sock[h, idx] = osock
            self.ct_out_circ[h, idx] = ocirc
            from shadow1_tpu_torch.consts import TCP_ESTABLISHED as _EST
            conn_up = r_sock is not None and self.m.socks[h][osock].st == _EST
            self.ct_pend[h, idx] = not conn_up
            if conn_up:
                self._push_cell(h, osock, self._meta(ocirc, 0, TOR_C_CREATE), TOR_CELL, now)
            if r_sock is None:
                self.m.eng.schedule_local(
                    h, now, K_APP, (TOR_OP_CONNECT_RELAY, osock, target)
                )
            return

        if from_out and cmd == TOR_C_CREATED:
            self._push_cell(
                h, int(self.ct_in_sock[h, idx]),
                self._meta(self.ct_in_circ[h, idx], 0, TOR_C_EXTENDED), TOR_CELL, now,
            )
            return

        if from_in and cmd == TOR_C_BEGIN and self.ct_out_sock[h, idx] < 0:
            self._push_cell(h, sock, self._meta(circ, aux, TOR_C_DATA), aux * TOR_CELL, now)
            self._push_cell(h, sock, self._meta(circ, 0, TOR_C_END), TOR_CELL, now)
            return

        # EXTEND with an existing out leg telescopes onward (mirror of tor.py
        # fwd_in; the fresh-out-leg case returned above).
        nbytes = aux * TOR_CELL if cmd == TOR_C_DATA else TOR_CELL
        if from_in and cmd != TOR_C_CREATED and self.ct_out_sock[h, idx] >= 0:
            self.cells_fwd[h] += 1
            self._push_cell(
                h, int(self.ct_out_sock[h, idx]),
                self._meta(self.ct_out_circ[h, idx], aux, cmd), nbytes, now,
            )
        elif from_out and cmd != TOR_C_CREATED:
            self.cells_fwd[h] += 1
            self._push_cell(
                h, int(self.ct_in_sock[h, idx]),
                self._meta(self.ct_in_circ[h, idx], aux, cmd), nbytes, now,
            )

    def summary(self):
        return {
            "streams_done": self.streams_done,
            "cells_rx": self.cells_rx,
            "bootstrap_time": self.bootstrap_time,
            "done_time": self.done_time,
            "cells_fwd": self.cells_fwd,
            "ct_overflow": self.ct_overflow,
            "cell_retries": self.cell_retries,
            "total_streams_done": int(self.streams_done.sum()),
            "total_cells_rx": int(self.cells_rx.sum()),
            "total_cells_fwd": int(self.cells_fwd.sum()),
            "total_ct_overflow": int(self.ct_overflow.sum()),
            "clients_done": int((self.done_time > 0).sum()),
        }

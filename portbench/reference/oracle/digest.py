"""The state-digest words of the oracle's state: one word per element
(an event, a send, a live socket, a host's NIC or counter row), a fold
``z = z·K + v`` of its fields onto a per-subsystem seed, hashed by the
splitmix finalizer twice, top 32 bits; a subsystem's word is the sum of
its elements' words. Plain Python ints for the per-event paths, numpy
uint64 for the [H] planes.
"""

from __future__ import annotations

import operator

import numpy as np

from portbench.reference.oracle.consts import NP
from portbench.reference.oracle.rng import _i64, _mix_np

_K = _i64(0x2545F4914F6CDD1D)
SEED_EVBUF = _i64(0xA0761D6478BD642F)
SEED_OUTBOX = _i64(0xE7037ED1A0B428DB)
SEED_TCP = _i64(0x8EBC6AF09C88C6E3)
SEED_MQ = _i64(0x589965CC75374CC3)
SEED_NIC = _i64(0x1D8E4E27C47D124F)
SEED_RNG = _i64(0xEB44ACCAB455D165)

# The TCP plane's canonical field order (the fold order of a socket).
TCP_FIELDS_I32 = (
    "st", "peer_host", "peer_sock",
    "snd_una", "snd_nxt", "snd_max", "rcv_nxt", "app_end",
    "fin_pend", "cwnd", "ssthresh", "peer_wnd",
    "dupacks", "recover", "ts_seq", "txr",
)
TCP_FIELDS_I64 = ("srtt", "rttvar", "rto", "rtx_t", "ts_time")
TCP_FIELDS_BOOL = ("timer_armed", "ts_act")

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_K_U = _K & _M64


def _mix_int(z: int) -> int:
    z ^= z >> 30
    z = (z * 0xBF58476D1CE4E5B9) & _M64
    z ^= z >> 27
    z = (z * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return z


def word_int(seed: int, fields) -> int:
    """One element's word from Python ints. i32-semantics fields come
    masked with ``& 0xFFFFFFFF``; i64 fields may be any int (folded mod
    2**64, the u64 reinterpretation)."""
    z = seed & _M64
    for v in fields:
        z = (z * _K_U + (int(v) & _M64)) & _M64
    return _mix_int(_mix_int(z)) >> 32


def event_word(host: int, time: int, tb: int, kind: int, p: tuple) -> int:
    """An event's word, as ``digest_evbuf`` hashes its slot; ``p`` is the
    (possibly short) payload tuple, missing columns zero."""
    fields = [host, time, tb, kind]
    fields += [int(p[i]) & _M32 if i < len(p) else 0 for i in range(NP)]
    return word_int(SEED_EVBUF, fields)


def packet_word(src: int, dst: int, depart: int, ctr: int, kind: int,
                p: tuple) -> int:
    """A send's word, as ``digest_outbox`` hashes its slot (``ctr`` is the
    sender's lifetime packet counter; the outbox plane keeps its low 32
    bits)."""
    fields = [src, dst, depart, ctr & _M32, kind]
    fields += [int(p[i]) & _M32 if i < len(p) else 0 for i in range(NP)]
    return word_int(SEED_OUTBOX, fields)


def sock_word(host: int, sock: int, k) -> int:
    """A live socket's words, as ``digest_tcp`` hashes it: ``k`` is the
    oracle's ``CpuSock``, its fields in the canonical tcp-plane order, then
    its message-boundary FIFO entries."""
    fields = [host, sock]
    fields += [getattr(k, f) & _M32 for f in TCP_FIELDS_I32]
    fields += [getattr(k, f) for f in TCP_FIELDS_I64]
    fields += [1 if getattr(k, f) else 0 for f in TCP_FIELDS_BOOL]
    total = word_int(SEED_TCP, fields)
    for end, meta in k.mq:
        total += word_int(SEED_MQ, [host, sock, end & _M32, meta & _M32])
    return total


def digest_socks_np(live) -> int:
    """The sum of ``sock_word`` over ``live``, a list of (host, sock,
    CpuSock) triples, as one numpy fold over all of them (the oracle's
    tcp word at a window boundary; every field fits int64)."""
    if not live:
        return 0
    get = operator.attrgetter(*TCP_FIELDS_I32, *TCP_FIELDS_I64,
                              *TCP_FIELDS_BOOL)
    cols = np.array([(h, s, *get(k)) for h, s, k in live], np.int64).T
    n32 = 2 + len(TCP_FIELDS_I32)
    cols[2:n32] &= _M32
    total = int(_words_np(SEED_TCP, list(cols)).astype(np.int64).sum())
    mq = [(h, s, end & _M32, meta & _M32)
          for h, s, k in live for end, meta in k.mq]
    if mq:
        total += int(_words_np(SEED_MQ, list(np.array(mq, np.int64).T))
                     .astype(np.int64).sum())
    return total


def _words_np(seed: int, fields) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = np.uint64(seed & _M64)
        for v in fields:
            v = np.asarray(v)
            if v.dtype == np.int32 or v.dtype == np.bool_:
                v = v.astype(np.uint32)
            z = z * np.uint64(_K_U) + v.astype(np.uint64)
        return (_mix_np(_mix_np(z)) >> np.uint64(32)).astype(np.uint32)


def digest_nic_np(tx_free, rx_free, tx_bytes, rx_bytes, aqm_ctr) -> int:
    """``digest_nic`` over the oracle's [H] NIC arrays."""
    h = np.arange(len(tx_free), dtype=np.int64)
    w = _words_np(SEED_NIC, [h, tx_free, rx_free, tx_bytes, rx_bytes,
                             aqm_ctr])
    return int(w.astype(np.int64).sum())


def digest_rng_np(vectors) -> int:
    """``digest_rng`` over the oracle's [H] counter arrays."""
    h = np.arange(len(vectors[0]), dtype=np.int64)
    w = _words_np(SEED_RNG, [h] + list(vectors))
    return int(w.astype(np.int64).sum())

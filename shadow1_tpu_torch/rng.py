"""Counter-based deterministic randomness, in torch int64.

The port of ``shadow1_tpu/rng.py``: every draw is a pure function of
``(seed, purpose, host, counter)`` — a splitmix64-style avalanche hash —
and every transform after it is integer arithmetic, so the port draws the
very bits the JAX engine draws.

torch has no full uint64 arithmetic, so the u64 pipeline runs on int64
tensors holding the same bit patterns:

* ``+`` and ``*`` on int64 wrap mod 2**64, which gives the bits of the u64
  operation;
* ``>>`` on int64 is arithmetic, the reference's u64 shift is logical, so
  every right shift of a value that may have its top bit set goes through
  ``_srl`` (shift, then mask off the copied sign bits);
* ``jax.lax.clz`` has no torch op: ``floor(log2 x)`` comes from ``frexp``
  in float64, as the reference's numpy twin does (exact for x ≤ 2**32).

Raw u32 draws are returned as int64 tensors in ``[0, 2**32)``. The seed key
is a Python int holding the u64 pattern as a signed int64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_M64 = (1 << 64) - 1


def _i64(u: int) -> int:
    """u64 bit pattern → the signed int64 with the same bits."""
    u &= _M64
    return u - (1 << 64) if u >> 63 else u


# splitmix64 finalizer constants and lane multipliers (rng.py:39-44).
_C1 = _i64(0xBF58476D1CE4E5B9)
_C2 = _i64(0x94D049BB133111EB)
_P1 = 0x9E3779B97F4A7C15
_P2 = _i64(0xC2B2AE3D27D4EB4F)
_P3 = _i64(0x165667B19E3779F9)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def base_key(seed: int) -> int:
    """The per-experiment key (u64 bits, as a signed Python int)."""
    return _i64(int(seed) * 0x9E3779B97F4A7C15 + 0x94D049BB133111EB)


def _mix(z: torch.Tensor) -> torch.Tensor:
    z = z ^ _srl(z, 30)
    z = z * _C1
    z = z ^ _srl(z, 27)
    z = z * _C2
    z = z ^ _srl(z, 31)
    return z


def bits(seed_key: int, purpose: int, host, ctr) -> torch.Tensor:
    """One u32 of raw randomness per (purpose, host, ctr), as int64 in
    [0, 2**32). ``host`` and ``ctr`` are tensors (any int dtype) that
    broadcast together."""
    z = (torch.as_tensor(host).to(torch.int64) * _P2
         + torch.as_tensor(ctr).to(torch.int64) * _P3
         + _i64(int(seed_key) + int(purpose) * _P1))
    return _srl(_mix(_mix(z)), 32)



def prob_threshold(p) -> np.ndarray:
    """Probability (host-side numpy) → u64 threshold such that
    ``bits < threshold`` has probability p (exact at 2**-32)."""
    return (np.round(np.asarray(p, np.float64) * 2.0 ** 32)).astype(np.uint64)


def uniform_lt(b: torch.Tensor, threshold) -> torch.Tensor:
    """Integer Bernoulli: True with probability threshold / 2**32.
    Thresholds are at most 2**32, so int64 compares them exactly."""
    return b < threshold


# --- fixed-point −ln(1−u) (rng.py:98-127) ----------------------------------
_LOG_BITS = 12
_LOG_TBL_NP = np.round(
    np.log2(1.0 + np.arange(2 ** _LOG_BITS + 1) / 2 ** _LOG_BITS) * 2.0 ** 32
).astype(np.int64)
_LN2_Q27 = int(round(np.log(2.0) * 2 ** 32)) >> 5


@functools.lru_cache(maxsize=None)
def _log_table(device: torch.device) -> torch.Tensor:
    """The Q32 log2 table on ``device``, copied once per device: a fresh
    host-to-device copy on every draw would stall the stream."""
    return torch.as_tensor(_LOG_TBL_NP, device=device)


def _neg_log1m_q32(b: torch.Tensor) -> torch.Tensor:
    """u32 bits → Q32 fixed-point −ln(1 − b/2**32), exact integer pipeline
    (the numpy twin ``_neg_log1m_q32_np``'s frexp path)."""
    x = (1 << 32) - b                                        # [1, 2**32]
    _, e = torch.frexp(x.to(torch.float64))
    k = e.to(torch.int64) - 1                                # floor(log2 x)
    m = torch.bitwise_left_shift(x, 63 - k)                  # top bit at 63
    frac = m & ((1 << 63) - 1)                               # (m << 1) >> 1
    idx = frac >> (63 - _LOG_BITS)
    rem = (frac >> (63 - _LOG_BITS - 24)) & ((1 << 24) - 1)
    tbl = _log_table(b.device)
    lo = tbl[idx]
    hi = tbl[idx + 1]
    log2_frac_q32 = lo + (((hi - lo) * rem) >> 24)
    log2_x_q32 = (k << 32) + log2_frac_q32
    e2_q32 = (32 << 32) - log2_x_q32                         # ≤ 2**37
    # The product can pass 2**63: wrap, then shift logically.
    return _srl(e2_q32 * _LN2_Q27, 27)


def exponential_ns(b: torch.Tensor, mean_ns) -> torch.Tensor:
    """u32 bits → int64 ns exponential with the given mean, clamped to ≥1.
    The mean rounds half-to-even in float64 and clamps to 2**38 ns, exactly
    as the reference does."""
    e_q32 = _neg_log1m_q32(b)
    if isinstance(mean_ns, torch.Tensor):
        mean = torch.round(mean_ns.to(torch.float64)).to(torch.int64)
        mean = torch.clamp(mean, max=1 << 38)
    else:
        mean = min(int(np.round(np.float64(mean_ns))), 1 << 38)
    e_hi = e_q32 >> 32
    e_lo = e_q32 & 0xFFFFFFFF
    d = mean * e_hi + ((mean * (e_lo >> 7)) >> 25)
    return torch.clamp(d, min=1)


def randint(b: torch.Tensor, n) -> torch.Tensor:
    """u32 bits → int32 in [0, n) by 64-bit multiply-shift."""
    return _srl(b * n, 32).to(torch.int32)

"""The geometric capacity ladder — quantized cap values (port of
``tune/ladder.py``, pure Python, copied so the port imports nothing of the
JAX package).

Caps are the shapes of the ``[C, H]`` event-buffer and ``[P, H]`` outbox
planes. An adaptive controller that chased the exact measured peak would
rebuild its engine every chunk (here: the host-side context, Tor's and the
fault plane's tables, the restart capture); quantizing to a fixed
geometric ladder bounds the reachable cap set to O(log(range)) values, so
the controller's engine cache stays small no matter how occupancy wanders.

The ladder interleaves powers of two with their 1.5× midpoints
(8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, ...): successive steps are
×1.33/×1.5, every value is lane-tiling-friendly, and the familiar config
caps (48, 96, 256, 512) are all on it.
"""

from __future__ import annotations

import math

# Smallest cap the tuner will ever pick; also the ladder's anchor.
LADDER_MIN = 8
# Default sizing headroom: target cap = quantize(ceil(peak * HEADROOM)).
# Fill gauges are window-end samples — a LOWER bound on the true mid-window
# peak (docs/PERF.md cap economics) — so the policy sizes generously and
# lets the overflow counters police the residual risk.
HEADROOM = 1.5
# A cap below ceil(peak * MIN_HEADROOM) is flagged under-provisioned
# (grow advice / controller grow trigger via grow_frac = 1/MIN_HEADROOM).
MIN_HEADROOM = 1.2


def cap_ladder(hi: int = 1 << 22) -> list[int]:
    """Ladder values in [LADDER_MIN, hi]: 8, 12, 16, 24, 32, 48, 64, 96, ..."""
    out: list[int] = []
    v = LADDER_MIN
    while v <= hi:
        out.append(v)
        if v + v // 2 <= hi:
            out.append(v + v // 2)
        v *= 2
    return out


def quantize_cap(need: int) -> int:
    """Smallest ladder value ≥ ``need``."""
    need = max(int(need), LADDER_MIN)
    v = LADDER_MIN
    while v < need:
        mid = v + v // 2  # the 1.5× midpoint comes before the next double
        if mid >= need:
            return mid
        v *= 2
    return v


def next_step(cap: int) -> int:
    """Smallest ladder value strictly above ``cap`` (cap need not be on it)."""
    return quantize_cap(int(cap) + 1)


def recommend_cap(peak: int, headroom: float = HEADROOM) -> int:
    """Measured peak fill → ladder-quantized recommended cap."""
    return quantize_cap(math.ceil(max(int(peak), 0) * headroom))


def classify(peak: int, cap: int, headroom: float = HEADROOM) -> dict:
    """Advisory verdict for one (measured peak, configured cap) pair.

    Returns ``{"verdict": "grow"|"shrink"|"ok", "recommended": int,
    "over_factor": float}`` — ``grow`` when the cap is under the minimum
    headroom over the peak (overflow risk), ``shrink`` when it exceeds the
    quantized target (over-provisioned by ``over_factor`` = cap/peak),
    ``ok`` when it sits in between (e.g. a hand-validated tight cap)."""
    peak, cap = int(peak), int(cap)
    target = recommend_cap(peak, headroom)
    floor = math.ceil(max(peak, 1) * MIN_HEADROOM)
    if cap < floor:
        verdict = "grow"
    elif cap > target:
        verdict = "shrink"
    else:
        verdict = "ok"
    return {
        "verdict": verdict,
        "recommended": target if verdict != "ok" else cap,
        "target": target,
        "over_factor": round(cap / max(peak, 1), 2),
    }

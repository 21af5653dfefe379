"""Times in configuration documents ("30 ms", "5 s", or nanoseconds)."""

from __future__ import annotations

_UNITS = {"ns": 1, "us": 10**3, "ms": 10**6, "s": 10**9, "sec": 10**9}


def parse_time_ns(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    num, unit = str(v).split()
    return int(float(num) * _UNITS[unit.lower()])

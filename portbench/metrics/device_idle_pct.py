"""Device: the share of an untraced pass in which no kernel, copy or set
ran on the device: the profiled pass's device busy time (which host
tracing does not change) against the mean wall of the window's untraced
passes (the profiled pass's own wall is longer by the profiler's host
work)."""


def read(rec):
    prof = rec["profile"]
    if not prof["device_sum_s"] or not rec["walls"]:
        return None
    wall = sum(rec["walls"]) / len(rec["walls"])
    return 100.0 * (1.0 - prof["busy_s"] / wall)

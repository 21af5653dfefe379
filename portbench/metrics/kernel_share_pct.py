"""Kernels: the three hand kernels' share of the profiled pass's device
time."""


def read(rec):
    prof = rec["profile"]
    if not prof["device_sum_s"]:
        return None
    return 100.0 * sum(prof["kernel_s"].values()) / prof["device_sum_s"]

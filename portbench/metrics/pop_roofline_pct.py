"""Kernels: the pop kernel's byte bound over its device time. The mean
bound of a call (its bytes at the card's memory rate) over the mean device
time of a profiled launch; nothing when the profile holds no launch."""


def read(rec):
    prof, calls = rec["profile"], rec["pop_bytes"]
    n = prof["kernel_records"]["pop"]
    if not n or not calls or not prof["kernel_s"]["pop"]:
        return None
    bound = sum(calls) / len(calls) / rec["hbm_bytes_per_s"]
    return 100.0 * bound / (prof["kernel_s"]["pop"] / n)

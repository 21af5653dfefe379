"""Window loop: the mean pass's wall over the rounds the engine ran in it."""


def read(rec):
    if not rec["rounds"]:
        return None
    return sum(rec["walls"]) / len(rec["walls"]) / rec["rounds"] * 1e3

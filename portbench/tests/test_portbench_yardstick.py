"""The frozen byte bounds (``yardstick.py``) against the bench-shape bounds
that ``chip_smoke.py`` printed on the card (phase 3, NVIDIA H100 80GB
HBM3): pop 21,041,836 B, push 7,395,036 B, obox 6,812,344 B. The data is
the phase's own: its generators, drawn from its seed in its order."""

from __future__ import annotations

import numpy as np

from portbench import yardstick

PRINTED = {"pop": 21041836, "push": 7395036, "obox": 6812344}


def bench_shape_arguments():
    """The arguments phase 3 timed each kernel on, regenerated on the
    CPU: the draws of ``check_pop``, ``check_push`` and ``check_obox`` in
    their order (the kernel calls between them draw nothing)."""
    import torch

    import chip_smoke as cs

    cs.use_shape(cs.BENCH_SHAPE)
    g = np.random.default_rng(20261016)
    dev = "cpu"
    # check_pop: the edge buffer, the two cases, then the timed buffer.
    cs.random_evbuf(g, dev, edge=True)
    cs.random_evbuf(g, dev)
    cs.random_evbuf(g, dev)
    pop_buf = cs.random_evbuf(g, dev)
    pop_until = torch.tensor(10**9 + 1000, dtype=torch.int64)
    # check_push: the three cases' buffers, then each case's rows and
    # push_back's tie-breaks.
    for kw in ({}, {"full": True}, {"edge": True}):
        cs.random_evbuf(g, dev, **kw)
    for edge in (False, False, True):
        cs._push_rows(g, dev, 0.7, edge=edge)
        g.integers(-2**33, 2**33, cs.H)
    push_buf = cs.random_evbuf(g, dev)
    push_mask = cs._push_rows(g, dev, 0.7)[0]
    # check_obox: the edge outbox, four cases, then the timed outbox.
    cs.random_outbox(g, dev, edge=True)
    cs.random_outbox(g, dev)
    cs._obox_rows(g, dev)
    cs.random_outbox(g, dev, full=True)
    cs._obox_rows(g, dev)
    cs._obox_rows(g, dev, edge=True)
    cs._obox_rows(g, dev, edge=True, scalar=True)
    cs._obox_rows(g, dev, edge=True, scalar=True)
    ob = cs.random_outbox(g, dev)
    rows = cs._obox_rows(g, dev)
    return {"pop": (pop_buf, pop_until), "push": (push_buf, push_mask),
            "obox": (ob, rows)}


def test_byte_bounds_match_the_printed_bench_shape_bounds():
    args = bench_shape_arguments()
    buf, until = args["pop"]
    assert yardstick.pop_bytes(buf, until) == PRINTED["pop"]
    buf, mask = args["push"]
    assert yardstick.push_bytes(buf, mask, True) == PRINTED["push"]
    ob, rows = args["obox"]
    assert yardstick.obox_bytes(ob, *rows[:4]) == PRINTED["obox"]


def test_the_rate_is_the_data_sheet_rate():
    assert yardstick.HBM_BYTES_PER_S == 3.35e12

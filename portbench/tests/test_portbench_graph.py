"""``graph_replay_pct``: the share of the span pass's handler passes that
ran as a replay of a CUDA graph, on made-up records; nothing without the
span pass.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

from portbench.harness import load_reader


def _rec(totals):
    """A run's records whose span pass is done, with these span totals."""
    return {"rounds": 10, "walls": [1.0], "spans": {"totals": totals}}


def test_every_handler_pass_a_replay_reads_100():
    read = load_reader("graph_replay_pct")
    assert read(_rec({"round:pop": (10, 900),
                      "round:h:phold": (10, 5_000),
                      "round:graph:replay": (10, 2_000),
                      "round:graph:capture": (3, 9_000)})) == 100.0


def test_no_replay_reads_0_and_a_share_counts_every_kind():
    read = load_reader("graph_replay_pct")
    assert read(_rec({"round:h:deliver": (12, 5_000),
                      "round:h:app": (8, 1_000)})) == 0.0
    assert read(_rec({"round:h:deliver": (12, 5_000),
                      "round:h:phold": (8, 1_000),
                      "round:graph:replay": (8, 400)})) == 40.0


def test_nothing_without_the_span_pass():
    read = load_reader("graph_replay_pct")
    assert read({"rounds": 10, "walls": [1.0], "spans": None}) is None
    assert read(_rec({"round:pop": (10, 900)})) is None
    assert read({"rounds": 0, "walls": [1.0]}) is None

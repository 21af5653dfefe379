"""The frozen oracle (``oracle``) with its seeds run side by side: one seed
per worker of a process pool, ``min(len(seeds), os.cpu_count())``
workers. The seeds of a sweep are independent runs, so the answer is the
oracle's, seed for seed; only the wall time falls.

The pool starts its workers with ``spawn``: the harness's process has
CUDA initialised, which a forked child cannot use or safely inherit. A
worker imports the oracle alone, nothing of the program. A worker that
dies (killed for memory, say) fails the call with ``BrokenProcessPool``
rather than leaving it waiting.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor


def _one(job: tuple) -> dict:
    """The oracle's output for one seed (a worker's task)."""
    from portbench.reference import oracle

    doc, seed, n_windows, control = job
    return oracle.expected(doc, [seed], n_windows, control=control)[0]


def expected(doc: dict, seeds: list[int], n_windows: int, device=None,
             control: str | None = None) -> list[dict]:
    """Per seed, in the order of ``seeds``: what ``oracle.expected`` gives
    for that seed alone."""
    seeds = [int(s) for s in seeds]
    if not seeds:
        return []
    workers = min(len(seeds), os.cpu_count() or 1)
    t0 = time.perf_counter()
    jobs = [(doc, s, n_windows, control) for s in seeds]
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        out = list(pool.map(_one, jobs))
    print(f"oracle_lanes: {len(seeds)} seeds on {workers} worker processes "
          f"({os.cpu_count()} cores) in {time.perf_counter() - t0:.3f} s",
          file=sys.stderr, flush=True)
    return out

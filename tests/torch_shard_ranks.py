"""Rank functions for the sharded-engine tests (``tests/test_torch_shard*``).

The ranks that ``shadow1_tpu_torch.shard.launch`` spawns import this
module by name, so it imports torch and the port only — never JAX, which
the test modules import."""

from __future__ import annotations

import time

import torch


def run_sharded(rank, world, exp, params, windows, mid=None,
                check_x2x=True, expect_raise=False):
    """One sharded run on CPU ranks: the gathered states at ``mid`` and at
    the end (numpy leaves), the metrics, the summary, the ring, flow and
    link records, the exchange caps, every rank's own rounds of the last
    ``run`` (``local_metrics``) and rank 0's count of the windows each
    compaction branch ran. With ``expect_raise`` a
    RuntimeError of ``run`` (every rank raises it alike) is returned as
    ``{"raised": message}``."""
    from shadow1_tpu_torch.convert import sharded_to_numpy
    from shadow1_tpu_torch.shard.engine import ShardedEngine
    from shadow1_tpu_torch.telemetry.links import drain_links
    from shadow1_tpu_torch.telemetry.probes import drain_probes
    from shadow1_tpu_torch.telemetry.ring import drain_ring

    from shadow1_tpu_torch.core import compact

    torch.set_num_threads(1)
    for k in compact.WINDOWS:
        compact.WINDOWS[k] = 0
    eng = ShardedEngine(exp, params, device="cpu")
    cap0 = eng._x2x_cap
    st = eng.init_state()
    out = {}
    try:
        if mid:
            st = eng.run(st, n_windows=mid, check_x2x=check_x2x)
            out["mid"] = sharded_to_numpy(eng, st)
        rest = None if windows is None else windows - (mid or 0)
        st = eng.run(st, n_windows=rest, check_x2x=check_x2x)
    except RuntimeError as e:
        if not expect_raise:
            raise
        return {"raised": str(e)}
    out.update(
        metrics=eng.metrics_dict(st),
        summary=eng.model_summary(st),
        end=sharded_to_numpy(eng, st),
        ring=drain_ring(st, eng.window),
        flow=drain_probes(st, eng.window, eng.params.probes),
        link=drain_links(st, eng.window),
        x2x_cap=(cap0, eng._x2x_cap, eng._full_cap),
        rank_rounds=_gather_int(int(eng.local_metrics.rounds), world),
        compact_windows=dict(compact.WINDOWS))
    return out


def _gather_int(v: int, world: int) -> list[int]:
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, v)
    return out


def carried(rank, world, exp, params, tree, windows):
    """The reference's global state ``tree`` (numpy leaves) placed on the
    ranks and run ``windows`` more: the gathered end state and metrics."""
    from shadow1_tpu_torch.convert import sharded_from_numpy, sharded_to_numpy
    from shadow1_tpu_torch.shard.engine import ShardedEngine

    torch.set_num_threads(1)
    eng = ShardedEngine(exp, params, device="cpu")
    st = eng.run(sharded_from_numpy(eng, tree), n_windows=windows)
    return {"metrics": eng.metrics_dict(st),
            "end": sharded_to_numpy(eng, st)}


def guarded(rank, world, exp, params, windows, chunk):
    """A sharded run under ``txn.OverflowGuard`` (``on_overflow: retry``),
    in chunks: the metrics, the guard's audit and the final bucket."""
    from shadow1_tpu_torch.ckpt import run_chunked
    from shadow1_tpu_torch.shard.engine import ShardedEngine
    from shadow1_tpu_torch.txn import OverflowGuard

    torch.set_num_threads(1)
    eng = ShardedEngine(exp, params, device="cpu")
    guard = OverflowGuard(eng, make_engine=eng.at_caps, mode="retry")
    st = run_chunked(eng, n_windows=windows, chunk=chunk, guard=guard)
    return {"metrics": eng.metrics_dict(st), "resizes": guard.resizes,
            "x2x_cap": guard.engine._x2x_cap,
            "full_cap": guard.engine._full_cap}


def slow_snapshot(rank, world, exp, params, windows, path, sleep_s):
    """A snapshotting run (``obs.run_with_heartbeat``, a save at every
    chunk) in which rank 0's first write, a mid-run one that the other
    ranks' next window waits for, first sleeps ``sleep_s``, longer than
    the group's timeout: the metrics and the windows done at each
    snapshot on disk."""
    from shadow1_tpu_torch import lineage
    from shadow1_tpu_torch.obs import run_with_heartbeat
    from shadow1_tpu_torch.shard.engine import ShardedEngine

    torch.set_num_threads(1)
    if rank == 0:
        save, slept = lineage.Lineage.save, []

        def slow_save(self, *a, **k):
            if not slept:
                slept.append(time.sleep(sleep_s))
            return save(self, *a, **k)

        lineage.Lineage.save = slow_save
    eng = ShardedEngine(exp, params, device="cpu")
    st, _ = run_with_heartbeat(eng, n_windows=windows, every_windows=2,
                               ckpt_path=path, ckpt_every_s=0.0,
                               emit_heartbeat=False, emit_ring=False)
    return {"metrics": eng.metrics_dict(st),
            "saved": [g.get("done_windows")
                      for g in lineage.Lineage(path).generations()]}


def clone_priced(rank, world, exp, params, windows):
    """The bytes of every clone ``ShardedEngine.run`` keeps of its input
    (``mem.live_bytes``, unique CPU storages) beside ``mem.estimate``'s
    rollback peak for one rank of this world."""
    from shadow1_tpu_torch import convert, mem
    from shadow1_tpu_torch.shard.engine import ShardedEngine

    torch.set_num_threads(1)
    clone, seen = convert.clone_state, []

    def counted(st):
        out = clone(st)
        seen.append(mem.live_bytes(out))
        return out

    convert.clone_state = counted
    try:
        eng = ShardedEngine(exp, params, device="cpu")
        eng.run(n_windows=windows)
    finally:
        convert.clone_state = clone
    return {"clones": seen,
            "rollback": mem.estimate(exp, params, n_dev=world)
            .peaks["rollback"]}


def mismatched(rank, world):
    """Rank 0 calls a collective that no other rank joins."""
    import torch.distributed as dist

    if rank == 0:
        dist.all_reduce(torch.ones(1))
    return rank


def fail_on_rank1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def world_info(rank, world):
    import torch.distributed as dist

    return rank, world, dist.get_backend()

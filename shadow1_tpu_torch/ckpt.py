"""Checkpoint / resume — snapshot the engine state, continue later (port of
``ckpt.py``).

A snapshot is the state's leaves, in the order ``jax.tree_util`` flattens
the JAX package's ``SimState`` (``convert.flatten_like_jax``), each with
the reference's dtype, in one ``.npz``: ``leaf_{i}``, ``format`` =
[CKPT_FORMAT, leaf count] and ``integrity``, a splitmix64 digest of every
leaf's bytes. The file is the reference's format, byte for byte in its
members, so a snapshot written by either package loads in the other, and
determinism makes the run that continues bit-identical to one that never
stopped. A snapshot saved at other event/outbox caps (an ``--auto-caps`` or
``--on-overflow retry`` run checkpoints at whatever caps it had grown to)
loads through the bit-exact cap migration of ``tune/resize.py``.
"""

from __future__ import annotations

import os

import numpy as np

# The reference's snapshot format (``shadow1_tpu/ckpt.py`` keeps the
# version history): v12 is the SimState with the optional ``telem`` ring,
# ``probes`` ring and ``links`` accumulator leaves, each present only when
# its plane is on, and the ``integrity`` digest.
CKPT_FORMAT = 12


class CorruptCheckpointError(ValueError):
    """The snapshot file is damaged (truncated zip, undecodable member, or
    integrity-digest mismatch) — as opposed to a well-formed snapshot of
    the wrong config, which stays a plain ValueError."""


_IM64 = (1 << 64) - 1
_IK = 0x2545F4914F6CDD1D           # the digest fold multiplier (core/digest)
_ISEED = 0xC6A4A7935BD1E995        # distinct seed: file integrity domain
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)


def _mix_int(z: int) -> int:
    """splitmix64's finalizer on a Python int (the reference's
    ``core/digest._mix_int``)."""
    z ^= z >> 30
    z = (z * 0xBF58476D1CE4E5B9) & _IM64
    z ^= z >> 27
    z = (z * 0x94D049BB133111EB) & _IM64
    z ^= z >> 31
    return z


def _mix_np(z):
    """splitmix64's finalizer on a uint64 array (the reference's
    ``rng._mix_np``); u64 wraparound is the point."""
    z = z ^ (z >> np.uint64(30))
    z = z * _C1
    z = z ^ (z >> np.uint64(27))
    z = z * _C2
    z = z ^ (z >> np.uint64(31))
    return z


def _integrity_digest(leaves) -> int:
    """Position-sensitive splitmix64 digest of the snapshot payload.

    Per leaf: the raw bytes (u64-padded) are each mixed with their word
    position and xor-reduced; leaf hashes then fold in order with the byte
    length, so any single flipped bit, swapped word, or truncated tail
    changes the digest. numpy only: a supervisor verifies checkpoints
    without touching the card."""
    z = _ISEED
    for i, a in enumerate(leaves):
        a = np.ascontiguousarray(np.asarray(a))
        b = a.tobytes()
        pad = (-len(b)) % 8
        u = np.frombuffer(b + b"\0" * pad, np.uint64)
        if u.size:
            with np.errstate(over="ignore"):
                pos = np.arange(u.size, dtype=np.uint64)
                w = _mix_np(u + _mix_np(pos * np.uint64(_IK)
                                        + np.uint64(i + 1)))
            h = int(np.bitwise_xor.reduce(w))
        else:
            h = 0
        z = _mix_int((z * _IK + h) & _IM64)
        z = (z * _IK + len(b)) & _IM64
    return _mix_int(z)


def _numpy_leaves(st) -> list[np.ndarray]:
    """The state's leaves in the reference's flatten order, copied to the
    host (``.cpu()``): the next chunk may update the device planes in
    place, so the snapshot must not alias them."""
    from shadow1_tpu_torch.convert import flatten_like_jax

    return [t.detach().cpu().numpy() for t in flatten_like_jax(st)]


def save_state(st, path: str) -> None:
    """Snapshot a SimState to ``path`` (.npz).

    Write-then-rename: a crash mid-write must leave the previous snapshot
    intact, never a truncated zip."""
    leaves = _numpy_leaves(st)
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    arrays["format"] = np.asarray([CKPT_FORMAT, len(leaves)], np.int64)
    arrays["integrity"] = np.asarray([_integrity_digest(leaves)], np.uint64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def _read(path: str):
    """(format, saved leaves, stored integrity) of a snapshot file."""
    try:
        with np.load(path) as data:
            fmt = (data["format"] if "format" in data.files
                   else np.asarray([1, -1]))
            n_saved = int(fmt[1])
            saved = [data[f"leaf_{i}"] for i in range(max(n_saved, 0))
                     if f"leaf_{i}" in data.files]
            stored = (int(data["integrity"][0])
                      if "integrity" in data.files else None)
    except Exception as e:  # truncated zip / undecodable member / bad header
        raise CorruptCheckpointError(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e}) — "
            f"truncated or damaged snapshot; discard it and re-run"
        ) from e
    return fmt, saved, stored


def load_state(template, path: str, migrate_caps: bool = True):
    """Load a snapshot into the structure of ``template`` (a SimState from
    ``engine.init_state()``), on the template's device. Shapes and dtypes
    must match the engine config.

    One sanctioned mismatch: with ``migrate_caps`` (default), a snapshot
    saved at another ``ev_cap``/``outbox_cap`` is migrated onto the
    template's caps (``tune/resize.py``, on the template's device; bit-exact
    — pop order lives in the (time, tb) keys, not slot indices). A shrink
    that would drop an event raises ValueError; every other shape or dtype
    difference fails as a config mismatch."""
    from shadow1_tpu_torch.convert import flatten_like_jax, unflatten_like_jax

    tleaves = flatten_like_jax(template)
    fmt, saved, stored = _read(path)
    _check_format(path, fmt, saved, stored, len(tleaves))
    leaves = saved
    if migrate_caps:
        i_ev, i_ob = _cap_leaves(template)
        caps = (saved[i_ev].shape[-2], saved[i_ob].shape[-2])
        want = (tleaves[i_ev].shape[-2], tleaves[i_ob].shape[-2])
        if caps != want:
            _check_leaves(path, saved, tleaves, shapes=False)
            from shadow1_tpu_torch.tune.resize import resize_state

            try:
                st = resize_state(unflatten_like_jax(template, saved),
                                  ev_cap=want[0], outbox_cap=want[1])
            except ValueError as e:
                raise ValueError(
                    f"checkpoint {path} cannot migrate onto this engine's "
                    f"caps ({e}) — rebuild the engine at the snapshot's "
                    f"caps (ckpt.snapshot_caps) or resume with "
                    f"--auto-caps, which does this automatically") from e
            leaves = flatten_like_jax(st)
    _check_leaves(path, leaves, tleaves)
    return unflatten_like_jax(template, leaves)


def _check_format(path, fmt, saved, stored, n_template: int) -> None:
    """The snapshot's format, completeness, integrity and leaf count."""
    n_saved = int(fmt[1])
    if int(fmt[0]) != CKPT_FORMAT:
        raise ValueError(
            f"checkpoint {path} has format v{int(fmt[0])}, this build "
            f"reads v{CKPT_FORMAT} — snapshot from an incompatible "
            f"framework version; re-run from scratch"
        )
    if stored is None or len(saved) != n_saved:
        raise CorruptCheckpointError(
            f"checkpoint {path} is missing state members "
            f"({len(saved)}/{n_saved} leaves, integrity "
            f"{'present' if stored is not None else 'absent'}) — truncated "
            f"snapshot; discard it and re-run"
        )
    if _integrity_digest(saved) != stored:
        raise CorruptCheckpointError(
            f"checkpoint {path} fails its integrity digest — the snapshot "
            f"was bit-corrupted after writing; discard it and re-run"
        )
    if n_saved != n_template:
        raise ValueError(
            f"checkpoint {path} holds {n_saved} state leaves, engine "
            f"expects {n_template} — engine config mismatch"
        )


def load_fleet_state(template, path: str, n_exp: int,
                     migrate_caps: bool = True):
    """Load a fleet snapshot (the reference's ``[E, ...]`` layout,
    ``convert.fleet_to_saved``) into the port's layout of ``template`` (a
    ``FleetEngine.init_state()``), migrating caps as ``load_state`` does;
    the migration runs on the port's layout, lane by lane the solo one."""
    from shadow1_tpu_torch.convert import (
        fleet_from_saved,
        fleet_to_saved,
        flatten_like_jax,
        unflatten_like_jax,
    )

    saved_t = fleet_to_saved(template, n_exp)
    fmt, saved, stored = _read(path)
    _check_format(path, fmt, saved, stored, len(flatten_like_jax(saved_t)))
    _check_leaves(path, saved, flatten_like_jax(saved_t), shapes=False)
    st = fleet_from_saved(unflatten_like_jax(saved_t, saved), template, n_exp)
    want = (template.evbuf.kind.shape[-2], template.outbox.dst.shape[-2])
    have = (st.evbuf.kind.shape[-2], st.outbox.dst.shape[-2])
    if migrate_caps and have != want:
        from shadow1_tpu_torch.tune.resize import resize_state

        st = resize_state(st, ev_cap=want[0], outbox_cap=want[1])
    _check_leaves(path, flatten_like_jax(st), flatten_like_jax(template))
    return st


def _check_leaves(path, leaves, tleaves, shapes: bool = True) -> None:
    """Every leaf (numpy array or tensor) has its template leaf's dtype
    and, with ``shapes``, its shape."""
    import torch

    for i, (have, want) in enumerate(zip(leaves, tleaves)):
        wdt = _np_dtype(want)
        hdt = _np_dtype(have) if isinstance(have, torch.Tensor) else have.dtype
        if ((shapes and tuple(have.shape) != tuple(want.shape))
                or hdt != wdt):
            raise ValueError(
                f"checkpoint leaf {i}: {tuple(have.shape)}/{hdt} != "
                f"engine state {tuple(want.shape)}/{wdt} — config mismatch"
            )


def _np_dtype(t) -> np.dtype:
    import torch

    return torch.empty((), dtype=t.dtype).numpy().dtype


def _cap_leaves(template) -> tuple[int, int]:
    """The leaf positions of the event kinds and the outbox destinations,
    whose slot axis (-2) is ev_cap and outbox_cap."""
    from shadow1_tpu_torch.convert import flatten_like_jax

    ids = [id(x) for x in flatten_like_jax(template)]
    return (ids.index(id(template.evbuf.kind)),
            ids.index(id(template.outbox.dst)))


def verify_file(path: str) -> tuple[bool, str | None]:
    """Host-side snapshot health check: (ok, reason-if-not).

    Reads the file with numpy only (no engine, no card) and checks the
    member set plus the integrity digest — the supervisor runs this before
    spawning a child on a leftover checkpoint, so a bit-corrupted snapshot
    is discarded like a stale one instead of crash-looping the respawn
    budget away."""
    try:
        with np.load(path) as data:
            if "format" not in data.files:
                return False, "no format member"
            n = int(data["format"][1])
            if "integrity" not in data.files:
                return False, "no integrity digest (pre-v8 or truncated)"
            stored = int(data["integrity"][0])
            leaves = []
            for i in range(n):
                if f"leaf_{i}" not in data.files:
                    return False, f"missing leaf_{i} of {n}"
                leaves.append(data[f"leaf_{i}"])
    except Exception as e:
        return False, f"unreadable ({type(e).__name__}: {e})"
    if _integrity_digest(leaves) != stored:
        return False, "integrity digest mismatch (bit corruption)"
    return True, None


def snapshot_caps(template, path: str) -> tuple[int, int] | None:
    """(ev_cap, outbox_cap) a snapshot was SAVED at, read off its leaf
    shapes without loading the full state; None when the snapshot's leaf
    layout does not match ``template`` (load_state's checks say why)."""
    i_ev, i_ob = _cap_leaves(template)
    try:
        with np.load(path) as data:
            for i in (i_ev, i_ob):
                if f"leaf_{i}" not in data.files:
                    return None
            ev, ob = data[f"leaf_{i_ev}"].shape, data[f"leaf_{i_ob}"].shape
    except Exception as e:  # truncated zip / undecodable member
        raise CorruptCheckpointError(
            f"checkpoint {path} is unreadable ({type(e).__name__}: {e}) — "
            f"truncated or damaged snapshot; discard it and re-run"
        ) from e
    if len(ev) < 2 or len(ob) < 2:
        return None
    return int(ev[-2]), int(ob[-2])


def run_chunked(engine, st=None, n_windows: int | None = None,
                chunk: int = 0, on_chunk=None, profiler=None, retune=None,
                guard=None, selfcheck: bool = False, drain=None):
    """Run in fixed-size window chunks, invoking ``on_chunk(st, done)`` after
    each (for checkpoints and heartbeats). Returns the final state.

    ``profiler`` (telemetry.PhaseProfiler) records one ``run-chunk`` span
    per chunk, synchronized with the device so the span covers the work,
    not its launch.

    The between-chunk hooks run in the reference's order: run →
    ``guard.commit`` → ``selfcheck`` → sample the drain latch →
    ``on_chunk`` → ``PreemptedExit`` → ``retune``.

    * ``guard`` (txn.OverflowGuard, CLI ``--on-overflow retry|halt``) makes
      chunks transactional: its rollback point (a device copy: the CUDA
      kernels update the planes in place) is taken before the chunk runs,
      and its commit accepts the chunk, replays it at grown caps or raises
      CapacityExceededError. Commit runs before ``on_chunk``, so
      heartbeats and checkpoints only see committed states.
    * ``selfcheck`` (CLI ``--selfcheck``) verifies the drop-accounting
      identity on every committed boundary (txn.SelfCheckError).
    * ``drain`` (preempt.DrainHandler): when a SIGTERM/SIGINT asked for a
      drain, the in-flight chunk is committed, ``on_chunk`` runs (which
      forces the final snapshot when the run keeps one) and
      preempt.PreemptedExit is raised — checked only at chunk boundaries.
    * ``retune(engine, st) -> (engine, st)`` (tune.CapController, CLI
      ``--auto-caps``) may hand back another engine, at other caps, with
      the state migrated; never called after the final chunk.

    The state is handed over, not kept: this frame holds no reference
    while a chunk runs, so the chunk-start leaves go once the chunk's
    windows replace them, and a guard's replay runs without the tainted
    result alive (``mem.py`` prices what stays)."""
    from shadow1_tpu_torch.telemetry import PH_INIT, PH_RUN_CHUNK, maybe_span

    if st is None:
        with maybe_span(profiler, PH_INIT):
            st = engine.init_state()
    if guard is not None:
        guard.bind(engine, st)
    total = n_windows if n_windows is not None else engine.n_windows
    if chunk <= 0:
        chunk = total
    done = 0
    while done < total:
        step = min(chunk, total - done)
        # Popping from a list passes the only reference on.
        rollback = [guard.rollback_point(st) if guard is not None else None]
        held = [st]
        st = None
        with maybe_span(profiler, PH_RUN_CHUNK, windows=step, done=done):
            held.append(guard.run_guarded(engine, held, step)
                        if guard is not None
                        else engine.run(held.pop(), n_windows=step))
            if profiler is not None:
                engine.synchronize()
        if guard is not None:
            engine, st = guard.commit(engine, rollback.pop(), held.pop(),
                                      done, step)
        else:
            st = held.pop()
        done += step
        if selfcheck:
            from shadow1_tpu_torch.txn import check_boundary_identity

            check_boundary_identity(
                type(engine).metrics_dict(st),
                where=f"chunk boundary, window {int(st.metrics.windows)}")
        # Sample the drain latch before on_chunk: on_chunk's forced save
        # can only see the latch as more set than this sample, so a raise
        # below always follows its snapshot; a signal landing inside
        # on_chunk is honored one boundary later.
        draining = drain is not None and drain.requested and done < total
        # Sharded: every rank drains at the same boundary.
        draining = engine.agree(draining)
        if on_chunk is not None:
            on_chunk(st, done)
        if draining:
            from shadow1_tpu_torch.preempt import PreemptedExit

            raise PreemptedExit(st=st, signame=drain.signame,
                                done_windows=done,
                                win_start=int(st.win_start))
        if retune is not None and done < total:
            engine, st = retune(engine, st)
            if guard is not None:
                guard.engine = engine
    return st

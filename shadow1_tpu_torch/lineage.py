"""Checkpoint lineage — rotated snapshot generations with a manifest (port
of ``lineage.py``, the same files and the same manifest schema, so either
package's ``Lineage.resolve`` reads a lineage the other wrote).

* the NEWEST generation always lives at the bare checkpoint path;
* older generations rotate to ``<path>.gNNNNNN`` (monotonic sequence
  numbers), pruned to ``keep`` in all;
* a ``<path>.lineage`` manifest (write-then-rename atomic) lists
  generation → win_start / done_windows / caps / format;
* :meth:`Lineage.resolve` walks newest→oldest and returns the first
  generation that passes ``ckpt.verify_file`` — a torn or bit-flipped
  head costs one generation of progress instead of the whole run.

Rotation order makes any kill instant safe: the new snapshot is fully
written to a temp file first, the old head is renamed to its generation
slot, then the temp is renamed in. ``SHADOW1_LINEAGE_CRASH_BETWEEN`` /
``SHADOW1_LINEAGE_TORN_HEAD`` inject a death at exactly those instants;
each names a flag file, so the injected death fires once, not on every
respawn.

numpy only at load/verify time (via ckpt): a supervisor resolves a
lineage without touching the card.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple


def write_json_atomic(path: str, obj) -> None:
    """Write-then-rename JSON sidecar write. Every sidecar the supervisor
    reads (.progress, .meta, .lineage) goes through here: a process killed
    mid-write must never leave a torn sidecar that makes the supervisor
    misread progress or abandon a perfectly resumable snapshot."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fire_once(env_var: str) -> bool:
    """Injection-hook latch: the env var names a flag file; the hook fires
    only while the file is absent, creating it first — so a supervised
    respawn (which inherits the env) proceeds instead of re-dying."""
    flag = os.environ.get(env_var)
    if not flag or os.path.exists(flag):
        return False
    with open(flag, "w") as f:
        f.write(env_var)
    return True


class ResolvedCkpt(NamedTuple):
    path: str | None     # the newest VALID generation file; None when
    #                      candidates existed but none passed verification
    seq: int             # its sequence number (-1 = unknown legacy head)
    meta: dict | None    # its manifest entry, when the manifest has one
    skipped: list        # newer-but-invalid candidates, newest first:
    #                      [{"file", "seq", "reason"}]


class Lineage:
    """Rotated generation set rooted at one checkpoint path."""

    def __init__(self, path: str, keep: int = 3):
        assert keep >= 1, keep
        self.path = path
        self.keep = keep
        self.manifest_path = path + ".lineage"

    # -- manifest ----------------------------------------------------------

    def _load_manifest(self) -> dict:
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
            if isinstance(m, dict) and isinstance(m.get("generations"), list):
                return m
        except (OSError, ValueError):
            pass
        return {"generations": []}

    def _gen_file(self, seq: int) -> str:
        return f"{self.path}.g{seq:06d}"

    def _scan_gens(self) -> list[tuple[int, str]]:
        """(seq, file) of on-disk rotated generations, oldest first — disk
        is the source of truth; the manifest only enriches."""
        d = os.path.dirname(self.path) or "."
        base = os.path.basename(self.path) + ".g"
        out = []
        try:
            names = os.listdir(d)
        except OSError:
            return []
        for name in names:
            if name.startswith(base):
                tail = name[len(base):]
                if tail.isdigit():
                    out.append((int(tail), os.path.join(d, name)))
        return sorted(out)

    def generations(self) -> list[dict]:
        """Manifest entries whose files still exist, oldest first (the
        head entry last). For reporting — resolve() does the verifying."""
        man = self._load_manifest()
        by_seq = {e.get("seq"): e for e in man["generations"]}
        out = []
        for seq, file in self._scan_gens():
            e = dict(by_seq.get(seq) or {"seq": seq})
            e["file"] = file
            out.append(e)
        if os.path.exists(self.path):
            head_seq = man.get("head_seq")
            e = dict(by_seq.get(head_seq) or {"seq": head_seq})
            e["file"] = self.path
            out.append(e)
        return out

    # -- save / rotate -----------------------------------------------------

    def save(self, st, meta: dict | None = None) -> int:
        """Snapshot ``st`` as the new head generation; rotate, prune, and
        update the manifest. Returns the new sequence number.

        ``meta`` (win_start / done_windows / total) rides the manifest entry
        so resume tooling and heartbeat_report can line generations up with
        sim time without opening the .npz files. Extra meta keys pass
        through verbatim (the reference's fleet plane keeps its lane ids
        there)."""
        from shadow1_tpu_torch import ckpt as _ckpt

        man = self._load_manifest()
        head_seq = man.get("head_seq")
        if head_seq is None and os.path.exists(self.path):
            # Legacy single-file checkpoint (pre-lineage): adopt it as the
            # generation before this one.
            gens = self._scan_gens()
            head_seq = gens[-1][0] + 1 if gens else 0
        seq = (head_seq + 1) if head_seq is not None else 0
        # 1) Fully write the new snapshot beside the head (atomic within).
        new_tmp = self.path + ".new"
        _ckpt.save_state(st, new_tmp)
        # 2) Rotate the current head to its generation slot — even at
        # keep=1: the prune below removes it AFTER the new head installs,
        # so no instant ever has zero snapshots on disk.
        if os.path.exists(self.path):
            os.replace(self.path, self._gen_file(head_seq))
        if _fire_once("SHADOW1_LINEAGE_CRASH_BETWEEN"):
            # Chaos hook: die exactly between rotate and install — the
            # worst mid-checkpoint-write instant (no head on disk).
            os._exit(137)
        # 3) Install the new head.
        os.replace(new_tmp, self.path)
        entries = [e for e in man["generations"]
                   if e.get("seq") is not None and e.get("seq") != seq]
        entry = {
            "seq": seq,
            "win_start": int(meta.get("win_start", 0)) if meta else 0,
            "done_windows": int(meta.get("done_windows", 0)) if meta else 0,
            "format": _ckpt.CKPT_FORMAT,
            "caps": {
                "ev_cap": int(st.evbuf.kind.shape[-2]),
                "outbox_cap": int(st.outbox.dst.shape[-2]),
            },
        }
        if meta:
            # Extra keys (fleet lanes / sub-batch cursor) ride verbatim;
            # the canonical ints above stay canonical.
            entry.update({k: v for k, v in meta.items()
                          if k not in entry})
        entries.append(entry)
        entries.sort(key=lambda e: e["seq"])
        # 4) Prune beyond ``keep`` (head included in the count).
        gens = self._scan_gens()
        while len(gens) > self.keep - 1:
            old_seq, old_file = gens.pop(0)
            try:
                os.remove(old_file)
            except OSError:
                pass
            entries = [e for e in entries if e["seq"] != old_seq]
        live = {s for s, _ in gens} | {seq}
        entries = [e for e in entries if e["seq"] in live]
        write_json_atomic(self.manifest_path,
                          {"keep": self.keep, "head_seq": seq,
                           "generations": entries})
        if _fire_once("SHADOW1_LINEAGE_TORN_HEAD"):
            # Chaos hook: simulate a torn head write (non-atomic fs / power
            # cut): truncate the freshly installed head, then die. The next
            # resolve() must skip it and fall back one generation.
            size = os.path.getsize(self.path)
            with open(self.path, "r+b") as f:
                f.truncate(max(size // 2, 1))
            os._exit(137)
        return seq

    # -- resolve -----------------------------------------------------------

    def resolve(self, discard_invalid: bool = False) -> ResolvedCkpt | None:
        """The newest generation that passes its integrity check.

        Returns None when no candidate file exists at all (fresh start);
        a ResolvedCkpt with ``path=None`` when candidates existed but none
        verified (every generation corrupt — ``skipped`` says why); else
        the newest valid generation with the invalid newer ones listed in
        ``skipped``.

        Walks head → rotated generations newest-first, verifying each with
        ``ckpt.verify_file``. With ``discard_invalid`` (the CLI child's
        mode), invalid candidates NEWER than the chosen one are deleted so
        a later save can never rotate a corrupt file into the generation
        set (when NO generation verifies, every candidate is deleted — the
        fresh start must not adopt a garbage head as a legacy snapshot);
        without it (the supervisor's read-only pre-spawn check), nothing
        on disk is touched."""
        from shadow1_tpu_torch.ckpt import verify_file

        man = self._load_manifest()
        by_seq = {e.get("seq"): e for e in man["generations"]}
        head_seq = man.get("head_seq")
        candidates: list[tuple[int, str]] = []
        if os.path.exists(self.path):
            candidates.append((head_seq if head_seq is not None else -1,
                               self.path))
        candidates.extend(reversed(self._scan_gens()))
        if not candidates:
            return None
        skipped: list[dict] = []
        for seq, file in candidates:
            ok, why = verify_file(file)
            if ok:
                if discard_invalid:
                    for s in skipped:
                        try:
                            os.remove(s["file"])
                        except OSError:
                            pass
                return ResolvedCkpt(file, seq, by_seq.get(seq), skipped)
            skipped.append({"file": file, "seq": seq, "reason": why})
        if discard_invalid:
            for s in skipped:
                try:
                    os.remove(s["file"])
                except OSError:
                    pass
        return ResolvedCkpt(None, -1, None, skipped)

    # -- cleanup -----------------------------------------------------------

    def sidecar_paths(self) -> list[str]:
        """Every lineage-owned file: head, rotated generations, manifest —
        what the supervisor deletes on a finished run or a stale config."""
        return ([self.path] + [f for _, f in self._scan_gens()]
                + [self.manifest_path])

    def remove_all(self) -> None:
        for p in self.sidecar_paths():
            try:
                os.remove(p)
            except OSError:
                pass

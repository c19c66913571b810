"""Rotating checksummed checkpoints, the last-good pointer, and the
resolver of ``--resume auto``.

The port of ``gsc_tpu.resilience.ckpt`` over the port's checkpoint format
(``utils.checkpoint``).  ``cli train --ckpt-interval N`` saves every N
episodes through a :class:`CheckpointManager`:

- every save records a sha256 of its files in the ``.meta.json`` sidecar
  and is validated after the write; a save that fails validation is
  written once more, and only a validated one moves the pointer;
- ``last_good.json`` is an atomically rewritten pointer to the newest
  validated checkpoint;
- only the newest ``retain`` checkpoints are kept (never the pointer's);
- ``fault_plan`` wires the ``ckpt_corrupt`` injection site (the first
  save at or after the keyed episode is damaged on disk after its write),
  and the rewrite after a failed validation is a ``recovery`` event
  through ``obs``.

On a mesh only rank 0 holds a manager; the trainer gathers the state and
the replay on every rank before it saves (``utils.checkpoint``).
:func:`find_resumable` walks a result tree for checksummed sidecars,
newest episode first, and returns the first checkpoint whose checksum
still validates: a damaged newest checkpoint falls back to the one
before.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import List, Optional, Tuple

from ..utils.checkpoint import (read_checkpoint_meta, save_checkpoint,
                                verify_checkpoint)

log = logging.getLogger("gsc_tpu_torch.resilience.ckpt")

POINTER_NAME = "last_good.json"
_META_SUFFIX = ".meta.json"


def corrupt_checkpoint(path: str) -> Optional[str]:
    """Truncate the largest file under a checkpoint to half its size (the
    ``ckpt_corrupt`` fault); returns that file, or None."""
    target, target_size = None, -1
    for root, _, files in os.walk(path):
        for name in files:
            fp = os.path.join(root, name)
            size = os.path.getsize(fp)
            if size > target_size:
                target, target_size = fp, size
    if target is None:
        return None
    with open(target, "r+b") as f:
        f.truncate(max(target_size // 2, 1))
    return target


def _write_atomic_json(path: str, obj) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class CheckpointManager:
    """Rotating checksummed checkpoints under one root directory:
    ``save`` writes ``<root>/ep<episode:08d>``, validates it (writing it
    once more if that fails), moves the ``last_good.json`` pointer and
    prunes all but the newest ``retain``."""

    def __init__(self, root: str, retain: int = 3,
                 meta: Optional[dict] = None, fault_plan=None, obs=None):
        self.root = os.path.abspath(root)
        self.retain = max(int(retain), 1)
        self.meta = dict(meta or {})
        self.fault_plan = fault_plan
        self.obs = obs

    def _path(self, episode: int) -> str:
        return os.path.join(self.root, f"ep{int(episode):08d}")

    @property
    def pointer_path(self) -> str:
        return os.path.join(self.root, POINTER_NAME)

    def save(self, state, buffer, episode: int,
             draws=None) -> Optional[str]:
        """Checkpoint after ``episode`` completed episodes; returns the
        path, or None when the second write failed validation too (the
        pointer then still names the previous good checkpoint)."""
        os.makedirs(self.root, exist_ok=True)
        path = self._path(episode)

        def write_ckpt():
            return save_checkpoint(
                path, state, buffer=buffer, draws=draws,
                extra={"episode": int(episode)},
                meta={**self.meta, "episode": int(episode)}, checksum=True)

        write_ckpt()
        if self.fault_plan is not None and self.fault_plan.fire(
                "ckpt_corrupt", episode, at_or_after=True):
            log.warning("fault ckpt_corrupt: damaged %s",
                        corrupt_checkpoint(path))
        if not verify_checkpoint(path):
            if self.obs is not None:
                self.obs.recovery(episode=episode, site="checkpoint",
                                  fault="checksum_mismatch", action="resave",
                                  detail=f"validation failed for {path}; "
                                         "rewriting once")
            else:
                log.warning("checkpoint %s failed checksum validation; "
                            "writing it once more", path)
            write_ckpt()
            if not verify_checkpoint(path):
                log.error("checkpoint %s failed validation twice; the "
                          "last-good pointer stays", path)
                return None
        _write_atomic_json(self.pointer_path, {
            "path": path, "episode": int(episode),
            "checksum": read_checkpoint_meta(path).get("checksum")})
        self._prune(keep=path)
        return path

    def _prune(self, keep: str):
        entries: List[Tuple[int, str]] = []
        for name in os.listdir(self.root):
            full = os.path.join(self.root, name)
            if name.startswith("ep") and os.path.isdir(full):
                try:
                    entries.append((int(name[2:]), full))
                except ValueError:
                    continue
        entries.sort(reverse=True)
        for _, full in entries[self.retain:]:
            if os.path.abspath(full) == os.path.abspath(keep):
                continue
            shutil.rmtree(full, ignore_errors=True)
            try:
                os.unlink(full + _META_SUFFIX)
            except OSError:
                pass


def find_resumable(search_root: str) -> Optional[str]:
    """The newest checkpoint under ``search_root`` (recursive) whose
    checksum validates: candidates are directories with a sidecar that
    records a checksum, newest first by the sidecar's episode, then by its
    modification time; a candidate that fails validation is logged and
    skipped."""
    search_root = os.path.abspath(search_root)
    candidates: List[Tuple[int, float, str]] = []
    for root, _, files in os.walk(search_root):
        for name in files:
            if not name.endswith(_META_SUFFIX):
                continue
            sidecar = os.path.join(root, name)
            ckpt = sidecar[:-len(_META_SUFFIX)]
            meta = read_checkpoint_meta(ckpt)
            if not meta.get("checksum") or not os.path.isdir(ckpt):
                continue
            try:
                mtime = os.path.getmtime(sidecar)
            except OSError:
                continue
            candidates.append((int(meta.get("episode", -1)), mtime, ckpt))
    for episode, _, ckpt in sorted(candidates, reverse=True):
        if verify_checkpoint(ckpt):
            log.info("resume auto: %s (episode %d) validates", ckpt, episode)
            return ckpt
        log.warning("resume auto: %s failed checksum validation; falling "
                    "back to the checkpoint before it", ckpt)
    return None

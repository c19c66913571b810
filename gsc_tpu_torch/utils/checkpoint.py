"""Checkpoints of the learner state, with a JSON metadata sidecar.

The port's counterpart of ``gsc_tpu.utils.checkpoint``, in a format of its
own: a checkpoint is a directory holding ``state.pt`` (the actor, the
critic, both Polyak targets, both Adam states, the ``extra`` counters such
as the completed-episode count that resume reads and, when given, the
``Draws`` generator's state) and, when a replay is given, ``buffer.pt``
(its tensors, write positions and fill counts), each written with
``torch.save`` and read back with ``torch.load(weights_only=True)``.
Metadata that a reader must know before it can build the networks (the
precision policy and the observation mode, ``graph_mode``) goes to a
``<path>.meta.json`` sidecar beside the directory, with the JAX package's
semantics:

- the sidecar sits next to the checkpoint directory, not inside it;
- a missing, truncated or non-object sidecar reads as ``{}`` (an f32
  checkpoint of before the policy existed);
- a save without ``meta`` (and without ``checksum``) removes a stale
  sidecar, so that an old policy never describes a new checkpoint.

``checksum=True`` records a sha256 over every file of the directory in
the sidecar; ``verify_checkpoint`` recomputes it.  ``load_full_or_partial``
restores the learner state alone, replay starting empty, when the saved
replay does not fit the one asked for (another ``mem_limit`` or replica
count).

A run on a mesh of ranks (``cli train --mesh``) writes this same format:
rank 0 saves the whole learner state and the whole replay, gathered from
every rank, and the generator state every rank shares; every rank of a
resumed run loads the same files and keeps its replica rows.  So a
checkpoint resumes under another mesh, or under none, wherever the
replica count divides (elastic resume).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import torch

log = logging.getLogger("gsc_tpu_torch.utils.checkpoint")

STATE_FILE = "state.pt"
BUFFER_FILE = "buffer.pt"
_NETS = ("actor", "critic", "target_actor", "target_critic")
_OPTS = ("actor_opt", "critic_opt")


def _meta_path(path: str) -> str:
    return os.path.abspath(path).rstrip(os.sep) + ".meta.json"


def _write_atomic(path: str, write):
    """``write(tmp_path)`` then rename onto ``path``: a crash mid-write
    never leaves a truncated file under the final name."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def checkpoint_checksum(path: str) -> str:
    """sha256 over every file under the checkpoint directory (sorted
    relative paths and their bytes): a truncated file, a lost rename or a
    flipped byte change it."""
    path = os.path.abspath(path)
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(files):
            fp = os.path.join(root, name)
            h.update(os.path.relpath(fp, path).encode())
            h.update(b"\0")
            with open(fp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            h.update(b"\0")
    return h.hexdigest()


def save_checkpoint(path: str, state, buffer=None, meta: Optional[dict] = None,
                    checksum: bool = False, draws=None,
                    extra: Optional[dict] = None) -> str:
    """Write the learner state ``state`` (a ``DDPGState``), the replay
    ``buffer``, the ``draws`` generator state and the ``extra`` ints (the
    JAX package's ``extra={"episode": n}``) when given, and the ``meta``
    sidecar; returns the absolute path of the directory."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {net: getattr(state, net).state_dict() for net in _NETS}
    for opt in _OPTS:
        payload[opt] = getattr(state, opt).state_dict()
    if extra is not None:
        payload["extra"] = {k: int(v) for k, v in extra.items()}
    if draws is not None:
        payload["draws"] = draws.generator.get_state()
    _write_atomic(os.path.join(path, STATE_FILE),
                  lambda tmp: torch.save(payload, tmp))
    buf_file = os.path.join(path, BUFFER_FILE)
    if buffer is not None:
        rb = {"data": buffer.data, "pos": buffer.pos, "size": buffer.size}
        _write_atomic(buf_file, lambda tmp: torch.save(rb, tmp))
    elif os.path.exists(buf_file):
        os.unlink(buf_file)
    if checksum:
        meta = dict(meta or {})
        meta["checksum"] = checkpoint_checksum(path)
        meta["checksum_algo"] = "sha256-tree"
    if meta is not None:
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(meta, f)
        _write_atomic(_meta_path(path), write)
    else:
        try:
            os.unlink(_meta_path(path))
        except OSError:
            pass
    return path


def read_checkpoint_meta(path: str) -> dict:
    """The ``save_checkpoint(meta=...)`` sidecar; ``{}`` when it is
    missing, unreadable or not a JSON object (logged)."""
    meta_path = _meta_path(path)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError, UnicodeDecodeError) as e:
        log.warning("checkpoint sidecar unreadable, read as {}: path=%s "
                    "error=%s: %s", meta_path, type(e).__name__, e)
        return {}
    if not isinstance(meta, dict):
        log.warning("checkpoint sidecar is not a JSON object, read as {}: "
                    "path=%s", meta_path)
        return {}
    return meta


def checkpoint_fingerprint(path: str) -> str:
    """Content identity of a checkpoint (the served weights' key in the
    ``serve_start`` and ``weight_swap`` events): the sidecar's recorded
    checksum when it has one, else the recomputed sha256 tree digest."""
    recorded = read_checkpoint_meta(path).get("checksum")
    if recorded:
        return recorded
    return checkpoint_checksum(path)


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` exists and its recomputed checksum equals the
    sidecar's recorded one (False for a checkpoint saved without
    ``checksum=True``)."""
    if not os.path.isdir(path):
        return False
    recorded = read_checkpoint_meta(path).get("checksum")
    return bool(recorded) and checkpoint_checksum(path) == recorded


def checkpoint_precision(path: str, precision: Optional[str] = None,
                         implicit: Optional[str] = "f32") -> Optional[str]:
    """The precision policy to run a checkpoint under: the sidecar's
    ``precision``; without a readable one, ``implicit``: "f32" to resume
    (a replay without a recorded policy can only be f32), None to serve or
    infer its actor, which then returns ``precision`` (None: the agent
    yaml's).  An explicit ``precision`` that contradicts the recorded or
    implicit policy raises ValueError (the JAX package's rule for
    ``--precision`` beside ``--resume``)."""
    meta = read_checkpoint_meta(path)
    recorded = meta.get("precision") or implicit
    if recorded is None:
        return precision
    if precision and precision != recorded:
        how = "recorded" if "precision" in meta else "implicit (no sidecar)"
        raise ValueError(
            f"--precision {precision} contradicts the checkpoint's {how} "
            f"policy ({recorded}); a checkpoint runs under its own "
            "precision: drop the flag or retrain")
    return recorded


def check_graph_mode(path: str, graph_mode: bool) -> None:
    """Refuse (ValueError) a checkpoint whose sidecar records the other
    observation mode than ``graph_mode``: a flat actor cannot take graph
    observations, nor the reverse.  A sidecar without the key (written
    before the port had flat mode) passes."""
    recorded = read_checkpoint_meta(path).get("graph_mode")
    if recorded is not None and bool(recorded) != bool(graph_mode):
        mode = lambda g: "true" if g else "false"
        raise ValueError(
            f"checkpoint {path} holds a graph_mode {mode(recorded)} agent, "
            f"the agent config has graph_mode {mode(graph_mode)}: give the "
            "agent yaml the checkpoint was trained with")


def _load(path: str, name: str):
    """A checkpoint file's tensors, on the CPU whatever device saved them."""
    return torch.load(os.path.join(os.path.abspath(path), name),
                      map_location="cpu", weights_only=True)


def load_actor_state(path: str) -> dict:
    """The actor's ``state_dict`` of a checkpoint (CPU tensors)."""
    return _load(path, STATE_FILE)["actor"]


def _restore_state(path: str, payload: dict, state, draws) -> dict:
    for net in _NETS:
        getattr(state, net).load_state_dict(payload[net])
    for opt in _OPTS:
        getattr(state, opt).load_state_dict(payload[opt])
    if draws is not None:
        if "draws" not in payload:
            raise ValueError(f"checkpoint {path} holds no Draws state")
        draws.generator.set_state(payload["draws"])
    return dict(payload.get("extra", {}))


def _replay_mismatch(path: str, rb: dict, buffer) -> Optional[str]:
    """Why the saved replay ``rb`` does not fit ``buffer``, or None."""
    if set(rb["data"]) != set(buffer.data):
        return (f"checkpoint {path} replay leaves {sorted(rb['data'])} "
                f"differ from the buffer's {sorted(buffer.data)}")
    for k, d in buffer.data.items():
        src = rb["data"][k]
        if src.shape != d.shape or src.dtype != d.dtype:
            return (f"checkpoint {path} replay leaf {k} is "
                    f"{tuple(src.shape)}/{src.dtype}, the buffer's "
                    f"{tuple(d.shape)}/{d.dtype}")
    return None


def _restore_buffer(rb: dict, buffer):
    for k, d in buffer.data.items():
        d.copy_(rb["data"][k])
    buffer.pos.copy_(rb["pos"])
    buffer.size.copy_(rb["size"])


def load_checkpoint(path: str, state, buffer=None, draws=None) -> dict:
    """Restore a checkpoint into ``state`` (a ``DDPGState`` of the same
    networks), and into ``buffer`` and ``draws`` when given, in place;
    every tensor keeps its device and takes the saved values bit for bit.
    Returns ``{"state": state, "buffer": buffer or None, "draws": draws or
    None, "extra": the saved extra ints ({} without)}``.  Raises when the
    checkpoint lacks what is asked for."""
    rb = None
    if buffer is not None:
        rb = _load(path, BUFFER_FILE)
        why = _replay_mismatch(path, rb, buffer)
        if why:
            raise ValueError(why)
    extra = _restore_state(path, _load(path, STATE_FILE), state, draws)
    if rb is not None:
        _restore_buffer(rb, buffer)
    return {"state": state, "buffer": buffer, "draws": draws, "extra": extra}


def load_full_or_partial(path: str, state, buffer=None, draws=None):
    """``load_checkpoint`` of the state, the replay and the random source,
    falling back to the state and the random source alone when the saved
    replay is missing or does not fit ``buffer`` (another storage dtype,
    ``mem_limit`` or replica count).  Returns ``(restored,
    buffer_restored)``; ``buffer`` is left as it was when not restored."""
    if buffer is not None:
        try:
            return load_checkpoint(path, state, buffer, draws), True
        except (FileNotFoundError, ValueError):
            pass   # the state's own faults raise again below
    return load_checkpoint(path, state, draws=draws), False

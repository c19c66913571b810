"""Mesh-shape + partition-rulebook grammar: torch-free and numpy-free.

The port's copy of ``gsc_tpu.meshspec``: the ``"DPxMP"`` mesh grammar and
the named-rulebook vocabulary, with the same results and the same error
texts.  The CLI, ``parallel/partition.py`` and ``parallel/mesh.py`` share
this one definition; importing it runs nothing but the grammar.

Canonical spellings, enforced here so cross-artifact grouping never
splits one value into two strings:

- mesh shapes are lowercase ``"dpxmp"`` with a bare ``"N"`` meaning
  ``"Nx1"`` (``canonical_mesh``);
- rulebook names are exactly the :data:`PARTITION_RULEBOOKS` tuple —
  ``replicated`` (bit-identical no-op fallback), ``sharded``
  (output-feature residency sharding, bit-exact by construction), and
  ``tp`` (true tensor-parallel compute, whose dispatch the port does not
  have yet — see ``parallel/partition.py``).
"""
from __future__ import annotations

import re
from typing import Tuple

#: named partition rulebooks every surface (cli/bench/dryrun/partition)
#: accepts, in increasing order of precision-contract spend:
#: replicated == bit-identical fallback, sharded == bit-exact residency
#: sharding, tp == psum-accumulated tensor-parallel compute gated by
#: tolerance bands instead of bit-equality.
PARTITION_RULEBOOKS: Tuple[str, ...] = ("replicated", "sharded", "tp")

_MESH_RE = re.compile(r"(\d+)(?:x(\d+))?")


def parse_mesh_shape(spec) -> Tuple[int, int]:
    """``"DPxMP"`` -> ``(dp, mp)``; a bare ``"N"`` means ``Nx1``.

    Raises ``ValueError`` with the offending text for anything else —
    callers (cli/bench) surface it as a flag error, never a traceback
    from deep inside mesh construction."""
    text = str(spec).strip().lower()
    m = _MESH_RE.fullmatch(text)
    if not m:
        raise ValueError(
            f"mesh shape {spec!r} is not 'DPxMP' (e.g. 8x1, 4x2) or 'N'")
    dp, mp = int(m.group(1)), int(m.group(2) or 1)
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh shape {spec!r} axes must be positive")
    return dp, mp


def canonical_mesh(spec) -> str:
    """The one spelling of a mesh shape every artifact records:
    lowercase ``"dpxmp"``, a bare ``"N"`` canonicalized to ``"Nx1"``.
    Validates via :func:`parse_mesh_shape` (same ``ValueError``
    contract)."""
    dp, mp = parse_mesh_shape(spec)
    return f"{dp}x{mp}"


def validate_partition_rules(name: str) -> str:
    """The canonical rulebook name, or ``ValueError`` naming the
    vocabulary — one message for every surface."""
    text = str(name).strip()
    if text not in PARTITION_RULEBOOKS:
        raise ValueError(
            f"unknown rulebook {text!r} "
            f"({'|'.join(PARTITION_RULEBOOKS)})")
    return text

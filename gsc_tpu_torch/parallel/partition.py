"""Partition rules over the learner state, and the sharded residency.

The port's counterpart of ``gsc_tpu.parallel.partition``: a regex rule
book over the names of the learner state's leaves gives each leaf a
partition spec over the ``dp x mp`` mesh (``parallel.mesh``), clamped to
replication where the mesh cannot split a width, and a
:class:`ShardingPlan` binds one mesh and one book.

Names and layouts are the port's own.  A leaf is named
``<part>/<parameter>`` for the four networks (``actor``, ``critic``,
``target_actor``, ``target_critic``: ``actor/mlp.layers.0.weight``) and
``<opt>/<state>/<parameter>`` for both Adam states
(``actor_opt/exp_avg/mlp.layers.0.weight``; ``exp_avg``, ``exp_avg_sq``
and the scalar ``step``).  A spec is a tuple with one entry per dim (an
axis name, a tuple of them, or None), ``()`` for replication: the JAX
package's ``PartitionSpec`` entries.  ``nn.Linear.weight`` is stored
``[out, in]``, flax's ``kernel`` ``[in, out]``, so the flax rule that
splits a kernel's last (output-feature) dim splits a torch ``weight`` on
**dim 0**; ``utils/convert.py`` ``_map_leaf`` holds that map, and the
rule tests go through it.

Two axes, two jobs, as in the JAX package:

- the replica axis of every data tree is carved over both mesh axes
  (rank ``r = dp_index * mp + mp_index`` owns rows
  :func:`ring_shard_rows` ``(B, dp * mp)[r]``), so the rows a rank rolls
  out depend only on the rank count, never on the carving;
- ``sharded`` splits output-feature dims over ``mp`` only, which are
  never contracted over.

The ``replicated`` and ``sharded`` books are the JAX package's ZeRO-style
residency (``_bind_sharded_dispatch``'s first branch): between dispatches
a rank holds only its mp slice of every matched leaf (parameters, Polyak
targets, both Adam moments); the full tensors exist only inside a
dispatch, gathered on entry (:meth:`ShardingPlan.gather_state`) and
sliced and freed on exit (:meth:`ShardingPlan.place_state`).  Every rank
computes the same full-batch update, so a slice is cut from the same
bits on every rank and the gather gives them back unchanged.  The ``tp``
book (contraction dims split, partial products summed across ranks) is a
table here only, for the rule tests: its dispatch is not ported yet.

``no_persistent_compile_cache`` of the JAX package guards XLA's
persistent compilation cache against multi-device CPU executables; the
port compiles no such programs and has no counterpart.
"""
from __future__ import annotations

import logging
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..meshspec import (PARTITION_RULEBOOKS, parse_mesh_shape,
                        validate_partition_rules)
from .mesh import Mesh, broadcast_rows, gather_rows

log = logging.getLogger("gsc_tpu_torch.parallel.partition")

Spec = Tuple[Any, ...]

#: the no-op rule book: every leaf replicated
REPLICATED_RULES: Tuple[Tuple[str, Spec], ...] = ((r".*", ()),)

_NETS = ("actor", "critic", "target_actor", "target_critic")
_OPTS = (("actor_opt", "actor"), ("critic_opt", "critic"))
_ADAM = ("step", "exp_avg", "exp_avg_sq")


def sharded_rules(mp_axis: str = "mp") -> Tuple[Tuple[str, Spec], ...]:
    """The DDPG rule book: every ``Linear`` weight (the MLPs, the factored
    heads' layers, the GATv2 projections ``lin_l``/``lin_r``) split on its
    output-feature dim (torch dim 0) over ``mp``, in the networks, the
    Polyak targets and both Adam moments alike.  Attention vectors,
    biases and step counts fall through to replication."""
    return (
        (r"\.weight$", (mp_axis, None)),
        (r".*", ()),
    )


def tp_rules(mp_axis: str = "mp") -> Tuple[Tuple[str, Spec], ...]:
    """The tensor-parallel rule book, in the port's names and layouts:
    the first MLP layer column-parallel (its weight's output dim 0 and
    its bias split), deeper MLP layers row-parallel (their weight's input
    dim 1 split), the GATv2 projections column-parallel.  A table only:
    the dispatch that computes with it is not ported yet."""
    return (
        (r"mlp\.layers\.0\.weight$", (mp_axis, None)),
        (r"mlp\.layers\.0\.bias$", (mp_axis,)),
        (r"mlp\.layers\.\d+\.weight$", (None, mp_axis)),
        (r"lin_[lr]\.weight$", (mp_axis, None)),
        (r".*", ()),
    )


#: rule-book name -> builder, the vocabulary of ``meshspec``
NAMED_RULEBOOKS: Dict[str, Callable] = {
    "replicated": lambda: REPLICATED_RULES,
    "sharded": sharded_rules,
    "tp": tp_rules,
}
assert tuple(NAMED_RULEBOOKS) == PARTITION_RULEBOOKS


# ------------------------------------------------------------ leaf names
def state_leaves(state) -> Dict[str, torch.Tensor]:
    """The learner state's tensors by leaf name (networks' parameters in
    ``named_parameters`` order, then each Adam state's tensors that
    exist: torch creates them at the first step)."""
    out: Dict[str, torch.Tensor] = {}
    for net in _NETS:
        for name, p in getattr(state, net).named_parameters():
            out[f"{net}/{name}"] = p
    for opt_name, net in _OPTS:
        opt = getattr(state, opt_name)
        for name, p in getattr(state, net).named_parameters():
            st = opt.state.get(p, {})
            for k in _ADAM:
                if torch.is_tensor(st.get(k)):
                    out[f"{opt_name}/{k}/{name}"] = st[k]
    return out


def learner_state_shapes(actor: torch.nn.Module, critic: torch.nn.Module
                         ) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of a learner state of these networks once Adam
    has stepped (its moments shaped like the parameters, ``step``
    scalar): what a run's state holds, before any of it exists."""
    out: Dict[str, Tuple[int, ...]] = {}
    nets = {"actor": actor, "critic": critic, "target_actor": actor,
            "target_critic": critic}
    for net in _NETS:
        for name, p in nets[net].named_parameters():
            out[f"{net}/{name}"] = tuple(p.shape)
    for opt_name, net in _OPTS:
        for name, p in nets[net].named_parameters():
            out[f"{opt_name}/step/{name}"] = ()
            out[f"{opt_name}/exp_avg/{name}"] = tuple(p.shape)
            out[f"{opt_name}/exp_avg_sq/{name}"] = tuple(p.shape)
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


# ---------------------------------------------------------- rule matching
def match_partition_rules(rules: Sequence[Tuple[str, Spec]],
                          leaves: Dict[str, Any]) -> Dict[str, Spec]:
    """Spec per leaf (a name -> tensor or shape dict): the first rule
    whose regex ``re.search``-matches the name wins.  Scalars and
    single-element leaves are never partitioned, whatever the rules; a
    leaf no rule matches is an error."""
    out = {}
    for name, leaf in leaves.items():
        shape = _shape(leaf)
        if len(shape) == 0 or math.prod(shape) == 1:
            out[name] = ()
            continue
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                out[name] = tuple(spec)
                break
        else:
            raise ValueError(f"no partition rule matched leaf {name!r} — "
                             "append a ('.*', P()) default rule")
    return out


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def clamp_specs_to_mesh(specs: Dict[str, Spec], leaves: Dict[str, Any],
                        mesh: Mesh) -> Tuple[Dict[str, Spec], int]:
    """Downgrade to ``()`` every spec whose split dim the mesh cannot
    divide evenly (or that out-ranks its leaf); returns ``(specs,
    n_clamped)``.  One rule book thus ports across mesh shapes and
    widths: ``sharded`` splits a 256-wide layer on ``mp=4`` and
    replicates a 22-wide projection the same mesh cannot divide."""
    sizes = mesh.shape
    out, clamped = {}, 0
    for name, spec in specs.items():
        shape = _shape(leaves[name])
        ok = len(spec) <= len(shape)
        for dim, entry in zip(shape, spec):
            if entry is None or not ok:
                continue
            size = math.prod(sizes[a] for a in _axes(entry))
            if size > 1 and dim % size != 0:
                ok = False
        if spec != () and not ok:
            log.debug("partition rule clamped to replication: %s %s on "
                      "mesh %s", name, shape, sizes)
            spec = ()
            clamped += 1
        out[name] = spec
    return out, clamped


def spec_str(spec: Spec) -> str:
    """A spec spelled as the JAX package's ``str(PartitionSpec(...))``."""
    return "PartitionSpec(" + ", ".join(repr(e) for e in spec) + ")"


def spec_summary(specs) -> Dict[str, int]:
    """``{spec string: leaf count}``: the partition layout ``run_start``
    records (counts by spec, never the whole tree)."""
    counts: Dict[str, int] = {}
    for spec in (specs.values() if isinstance(specs, dict) else specs):
        key = spec_str(tuple(spec))
        counts[key] = counts.get(key, 0) + 1
    return dict(sorted(counts.items()))


# -------------------------------------------------------- shard / gather
def _split(spec: Spec, mesh: Mesh) -> Optional[Tuple[int, int, int]]:
    """(dim, parts, this rank's part) of a spec that splits one dim over
    ``mp``, or None for a replicated spec (or an mp axis of one)."""
    split = [(d, e) for d, e in enumerate(spec) if e is not None]
    if not split or math.prod(mesh.shape[a] for a in _axes(split[0][1])) == 1:
        return None
    if len(split) > 1 or _axes(split[0][1]) != ("mp",):
        raise ValueError(f"spec {spec_str(spec)}: the residency splits one "
                         "dim over 'mp' only")
    return split[0][0], mesh.mp, mesh.mp_index


def shard_leaf(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full leaf (a copy, so the full storage can
    be freed), or ``x`` itself for a replicated spec."""
    s = _split(spec, mesh)
    if s is None:
        return x
    dim, parts, mine = s
    k = x.shape[dim] // parts
    return x.narrow(dim, mine * k, k).clone()


def gather_leaves(slices: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices -> the full leaves on every rank of the mp
    group: each mp rank's slices of every split leaf move as one byte
    buffer (one broadcast per mp rank, a collective of the group); a leaf
    of a replicated spec comes back as it is."""
    split = {k: _split(specs[k], mesh) for k in slices}
    names = [k for k in slices if split[k] is not None]
    out = {k: v for k, v in slices.items() if split[k] is None}
    if not names:
        return out
    # every slice moved to dim 0 and flattened into one row per owner
    moved = {k: slices[k].movedim(split[k][0], 0).contiguous()
             for k in names}
    flat = [moved[k].reshape(1, -1) for k in names]
    parts = [broadcast_rows(flat, src, flat, 1, mesh.device,
                            group=mesh.mp_group)
             for src in mesh.mp_ranks()]
    for i, k in enumerate(names):
        full = torch.cat([p[i].reshape(moved[k].shape) for p in parts])
        out[k] = full.movedim(0, split[k][0]).contiguous()
    return out


def make_shard_and_gather_fns(specs: Dict[str, Spec], mesh: Mesh
                              ) -> Tuple[Dict[str, Callable],
                                         Dict[str, Callable]]:
    """Per-leaf ``shard(x)`` (full leaf -> this rank's slice) and
    ``gather(x)`` (slice -> the full leaf on every rank of the mp group,
    :func:`gather_leaves` of one leaf: a collective) callables."""
    def make_shard(spec):
        return lambda x: shard_leaf(x, spec, mesh)

    def make_gather(name):
        return lambda x: gather_leaves({name: x}, specs, mesh)[name]

    return ({k: make_shard(s) for k, s in specs.items()},
            {k: make_gather(k) for k in specs})


def apply_fns(fns: Dict[str, Callable], tree: Dict[str, Any]
              ) -> Dict[str, Any]:
    """Apply per-leaf callables to the matching leaves of a dict."""
    return {k: fns[k](v) for k, v in tree.items()}


def _set_leaf(state, name: str, value: torch.Tensor) -> None:
    """Rebind one learner-state leaf (a parameter's data or an Adam
    tensor) to ``value``."""
    part, rest = name.split("/", 1)
    if part in _NETS:
        p = dict(getattr(state, part).named_parameters())[rest]
        p.data = value
        p.grad = None
        return
    key, pname = rest.split("/", 1)
    net = dict(_OPTS)[part]
    p = dict(getattr(state, net).named_parameters())[pname]
    getattr(state, part).state[p][key] = value


# ------------------------------------------------------------- the plan
class ShardingPlan:
    """One mesh and one rule book.

    ``ParallelDDPG`` reads ``rows`` (this rank's replica rows) and
    gathers each gradient step's batch through :meth:`gather_batch`;
    around each dispatch it calls :meth:`gather_state` (entry) and
    :meth:`place_state` (exit); checkpoints gather the replay with
    :meth:`gather_buffers`; the CLI records :meth:`describe` and
    :meth:`summary`.  ``rules`` is a rule book or one of the named books
    ``"replicated"`` (default), ``"sharded"`` and ``"tp"``."""

    def __init__(self, mesh: Mesh, rules="replicated"):
        self.rules_name = rules if isinstance(rules, str) else "custom"
        if isinstance(rules, str):
            rules = NAMED_RULEBOOKS[validate_partition_rules(rules)]()
        self.mesh = mesh
        self.rules = tuple(rules)
        self.dp, self.mp = mesh.dp, mesh.mp
        # leaf name -> clamped spec, bound from full shapes (a sliced
        # leaf's shape would clamp differently) and kept for the run
        self._specs: Dict[str, Spec] = {}
        self.clamped = 0
        # the residency's counters: dispatch entries that gathered a
        # split leaf, the bytes a rank held between dispatches, and the
        # batch gathers' seconds and count
        self.entry_gathers = 0
        self.resident_bytes = 0
        self.full_bytes = 0
        self.gather_s = 0.0
        self.gathers = 0

    @classmethod
    def from_spec(cls, spec: str, rules="replicated") -> "ShardingPlan":
        """A plan over a layout-only mesh of ``spec`` (no process group):
        its specs and summary, for rank-independent questions."""
        dp, mp = parse_mesh_shape(spec)
        return cls(Mesh.layout(dp, mp), rules=rules)

    @property
    def n_devices(self) -> int:
        return self.dp * self.mp

    def describe(self) -> str:
        return f"{self.dp}x{self.mp}"

    @property
    def is_sharded(self) -> bool:
        """True iff a rule can split a leaf (mp > 1 and a non-() rule)."""
        return self.mp > 1 and any(spec != () for _, spec in self.rules)

    @property
    def resident_sharded(self) -> bool:
        """True for the ``tp`` book, whose state would stay sharded through
        the computation: not ported yet."""
        return self.rules_name == "tp"

    def rows(self, num_replicas: int) -> Tuple[int, int]:
        """This rank's replica rows ``[lo, hi)``."""
        return ring_shard_rows(num_replicas, self.n_devices)[self.mesh.rank]

    # -------------------------------------------------------- state specs
    def specs(self, leaves: Dict[str, Any]) -> Dict[str, Spec]:
        """Clamped spec per leaf of a name -> tensor or shape dict of FULL
        leaves (rank-independent)."""
        specs = match_partition_rules(self.rules, leaves)
        specs, self.clamped = clamp_specs_to_mesh(specs, leaves, self.mesh)
        return specs

    def state_specs(self, state) -> Dict[str, Spec]:
        """Specs of a learner state holding full tensors; remembered for
        the later gathers of its slices."""
        specs = self.specs(state_leaves(state))
        self._specs.update(specs)
        return specs

    def summary(self, leaves) -> Dict[str, int]:
        """``{spec: leaf count}`` of a learner state or a name -> shape
        dict (``learner_state_shapes``)."""
        if not isinstance(leaves, dict):
            leaves = state_leaves(leaves)
        return spec_summary(self.specs(leaves))

    def split_leaves(self) -> List[str]:
        """Names of the leaves this rank holds a slice of."""
        return [k for k, s in self._specs.items() if _split(s, self.mesh)]

    # ------------------------------------------------------- residency
    @torch.no_grad()
    def place_state(self, state):
        """Full learner state -> this plan's residency, in place: each
        split leaf rebound to this rank's slice (the full tensor freed);
        returns ``state``."""
        leaves = state_leaves(state)
        specs = self.state_specs(state)
        self.full_bytes = _nbytes(leaves.values())
        for name, spec in specs.items():
            if _split(spec, self.mesh):
                _set_leaf(state, name, shard_leaf(leaves[name], spec,
                                                  self.mesh))
        self.resident_bytes = _nbytes(state_leaves(state).values())
        return state

    @torch.no_grad()
    def gather_state(self, state):
        """The residency -> the full learner state on every rank, in
        place (:func:`gather_leaves`: one byte broadcast per mp rank over
        the mp group, a collective of every rank); returns ``state``."""
        leaves = state_leaves(state)
        names = [k for k in self.split_leaves() if k in leaves]
        if not names:
            return state
        self.entry_gathers += 1
        full = gather_leaves({k: leaves[k] for k in names}, self._specs,
                             self.mesh)
        for k in names:
            _set_leaf(state, k, full[k])
        return state

    # ---------------------------------------------------------- data rows
    def gather_batch(self, data: Dict[str, torch.Tensor], bidx: torch.Tensor,
                     sidx: torch.Tensor, num_replicas: int
                     ) -> Dict[str, torch.Tensor]:
        """One batch ``data[bidx, sidx]`` of the global replay from the
        rows each rank holds (``data`` [rows, capacity, ...]): each rank
        takes its rows in batch order, the ranks' rows move as bytes, and
        every rank ends with the same batch in the same order."""
        per = num_replicas // self.n_devices
        lo = self.mesh.rank * per
        if self.n_devices == 1:
            return {k: d[bidx, sidx] for k, d in data.items()}
        owner = torch.div(bidx, per, rounding_mode="floor")
        counts = torch.bincount(owner, minlength=self.n_devices).tolist()
        order = torch.argsort(owner, stable=True)
        mine = order[sum(counts[:self.mesh.rank]):
                     sum(counts[:self.mesh.rank + 1])]
        local = {k: d[bidx[mine] - lo, sidx[mine]] for k, d in data.items()}
        got = gather_rows(self.mesh, local, counts)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        return {k: v[inv] for k, v in got.items()}

    def gather_replica_rows(self, leaves: Dict[str, torch.Tensor],
                            num_replicas: int) -> Dict[str, torch.Tensor]:
        """Per-replica leaves ([rows, ...] on each rank) -> [B, ...] in
        global replica order on every rank."""
        per = num_replicas // self.n_devices
        return gather_rows(self.mesh, leaves, [per] * self.n_devices)

    def gather_buffers(self, buffers, num_replicas: int):
        """The whole replay ([B, capacity, ...]) on every rank, from each
        rank's shard rows: what a checkpoint holds."""
        from ..agents.buffer import ReplayBuffer

        leaves = dict(buffers.data)
        leaves["__pos"] = buffers.pos
        leaves["__size"] = buffers.size
        got = self.gather_replica_rows(leaves, num_replicas)
        return ReplayBuffer(
            data={k: v for k, v in got.items() if not k.startswith("__")},
            pos=got["__pos"], size=got["__size"], shapes=buffers.shapes)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ring_shard_rows(num_replicas: int,
                    n_shards: int) -> Tuple[Tuple[int, int], ...]:
    """The static row -> shard map of the replica axis: shard ``s`` owns
    rows ``[s*B/n, (s+1)*B/n)``, one ``(lo, hi)`` per shard."""
    B, n = int(num_replicas), int(n_shards)
    if n <= 0 or B % n != 0:
        raise ValueError(
            f"num_replicas ({B}) must divide evenly over {n} ring shards")
    per = B // n
    return tuple((s * per, (s + 1) * per) for s in range(n))


def actor_shard_assignment(n_actors: int, n_shards: int) -> Tuple[int, ...]:
    """Stable actor -> dp-shard assignment: actor ``a`` reports against
    shard ``a % n_shards``, forever (an observability contract)."""
    return tuple(a % max(1, int(n_shards)) for a in range(int(n_actors)))

"""The training mesh on ``torch.distributed``: one process per rank.

The port's counterpart of ``gsc_tpu.parallel.mesh``.  The JAX package
drives its ``dp x mp`` device grid from one controller; here every rank is
a process of its own, and a :class:`Mesh` record is what each of them
knows of the grid:

- ``rank = dp_index * mp + mp_index``, the row-major order in which the
  JAX package's ``P(("dp", "mp"))`` carves the replica axis, so rank ``r``
  owns replica rows ``partition.ring_shard_rows(B, dp * mp)[r]``;
- ``mp_group`` holds the ranks that share this rank's dp index
  (``new_group``): the sharded residency gathers a learner-state leaf's
  slices over it.  No collective runs over the dp axis alone (every rank
  computes the same full-batch update), so there is no dp group.

:func:`launch` spawns the ranks (the ``spawn`` start method: CUDA does
not survive a fork), meets them at a ``FileStore`` in a temporary
directory (no TCP port is chosen, so launches running side by side never
collide), and returns each rank's result.  The first rank that fails
kills the others and the launch raises with that rank's traceback; at the
deadline every rank is killed.  On the card it builds (or loads) the
kernel libraries before spawning, so no rank runs nvcc.
:func:`init_distributed` joins a ``torchrun`` environment instead
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``): the
counterpart of ``jax.distributed.initialize``.  ``force_virtual_cpu`` of
the JAX package has its counterpart in ``device="cpu"``: CPU ranks, over
gloo.

Backends: ranks on the CPU use gloo, each on a fixed number of torch
threads; ranks on CUDA with one card each use NCCL.  More ranks than
cards only comes from an explicit ``devices=[...]`` list (ranks sharing
a card, over gloo); the CLI never asks for it.

One thread of each rank may use the process group: the thread that
carved its mesh (:func:`carve`, which calls :func:`collective_thread`:
the rank's main thread, under ``train --async --mesh`` the learner).
Every collective checks that first and raises
:class:`CollectiveThreadError` naming the calling thread otherwise: gloo
and NCCL match collectives by the order each rank issues them, and two
threads issuing them beside each other would order them differently on
two ranks (a hang, or buffers of equal size swapped without an error).

Collectives are ``broadcast`` and ``all_reduce`` only, on tensors of the
rank's device: the two operations gloo implements for CUDA tensors, so
one code path runs on NCCL, on gloo with CPU tensors and on gloo with
CUDA tensors.  Rows move as bytes (:func:`gather_rows`,
:func:`broadcast_rows`): each owner packs its rows of every leaf into
one ``uint8`` buffer and broadcasts it once, so a gathered float is the
owner's float bit for bit (a sum of zero-padded buffers would turn
``-0.0`` into ``+0.0``).
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import shutil
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.cost import post_collective


#: seconds a collective waits for its peers before it raises
TIMEOUT_S = 600.0
#: the launcher's test hook from the environment: this rank raises once
#: it has joined (as ``launch(fail_rank=)``)
FAIL_RANK_ENV = "GSC_MESH_FAIL_RANK"

# the one thread of this process that may issue collectives (None: any)
_OWNER: List[Optional[threading.Thread]] = [None]


class CollectiveThreadError(RuntimeError):
    """A collective issued from a thread that does not own the process
    group."""


def collective_thread() -> None:
    """Make the calling thread the only thread of this process that may
    issue collectives."""
    _OWNER[0] = threading.current_thread()


def check_collective_thread() -> None:
    """Raise :class:`CollectiveThreadError` unless the calling thread owns
    the process group."""
    owner, me = _OWNER[0], threading.current_thread()
    if owner is not None and me is not owner:
        raise CollectiveThreadError(
            f"a collective issued from thread {me.name!r}: only "
            f"{owner.name!r} may use this rank's process group (ranks "
            "match collectives by the order each issues them)")


def _collective(op: str, nbytes: int) -> None:
    """Before every collective: count it (``ops.cost.post_collective``,
    per thread and under a capture), then the thread check."""
    post_collective(op, nbytes)
    check_collective_thread()


@dataclass
class Mesh:
    """One rank's view of a ``dp x mp`` grid of ``world`` ranks."""

    dp: int
    mp: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None   # None: a layout only, no process group
    mp_group: Any = None
    # seconds from the launcher's spawn to the joined process group
    startup_s: Optional[float] = None

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}

    def describe(self) -> str:
        return f"{self.dp}x{self.mp}"

    def mp_ranks(self) -> List[int]:
        """The ranks of this rank's mp group, by mp index."""
        return [self.dp_index * self.mp + m for m in range(self.mp)]

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @classmethod
    def layout(cls, dp: int, mp: int, rank: int = 0) -> "Mesh":
        """A grid without a process group: its rule books and row map."""
        return cls(dp=dp, mp=mp, rank=rank)

    def recarve(self, dp: int, mp: int) -> "Mesh":
        """The same ranks carved ``dp x mp`` (``dp * mp`` must be the
        world size), with mp groups of its own.  Every rank calls it, in
        the same order."""
        if dp * mp != self.world:
            raise ValueError(f"mesh {dp}x{mp} is not a carving of "
                             f"{self.world} ranks")
        return carve(dp, mp, self.rank, self.device, self.backend,
                     startup_s=self.startup_s)

    # ------------------------------------------------------- agreement
    def _reduce(self, value: float, op) -> float:
        if self.world == 1 or not self.distributed:
            return float(value)
        t = torch.tensor([float(value)], dtype=torch.float32,
                         device=self.device)
        _collective("all-reduce", t.numel() * t.element_size())
        dist.all_reduce(t, op=op)
        return float(t.item())

    def agree_min(self, values: Sequence[int]) -> List[int]:
        """The element-wise minimum over ranks of an integer vector (one
        all_reduce MIN of int64; exact for any step count).  Every rank
        passes a vector of the same length."""
        if self.world == 1 or not self.distributed:
            return [int(v) for v in values]
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        _collective("all-reduce", t.numel() * t.element_size())
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return [int(v) for v in t.tolist()]

    def agree_any(self, flag: bool) -> bool:
        """True on every rank when it is true on any (all_reduce MAX)."""
        return self._reduce(1.0 if flag else 0.0, dist.ReduceOp.MAX) > 0

    def agree_all(self, flag: bool) -> bool:
        """True on every rank when it is true on all (all_reduce MIN)."""
        return self._reduce(1.0 if flag else 0.0, dist.ReduceOp.MIN) > 0


def carve(dp: int, mp: int, rank: int, device, backend: Optional[str],
          startup_s: Optional[float] = None) -> Mesh:
    """The :class:`Mesh` of ``rank`` in an initialised process group of
    ``dp * mp`` ranks, with its mp group (every rank creates every group,
    in the same order).  The calling thread becomes the one that may
    issue collectives (:func:`collective_thread`)."""
    collective_thread()
    mesh = Mesh(dp=dp, mp=mp, rank=rank, device=torch.device(device),
                backend=backend, startup_s=startup_s)
    if backend is None or mp == 1:
        return mesh
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if mesh.dp_index == d:
            mesh.mp_group = g
    return mesh


# ------------------------------------------------------------ bytes of rows
def pack_rows(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """[n, ...] leaves of any dtypes -> one ``uint8`` buffer [n, bytes]
    holding each row's bytes of every leaf, leaf after leaf."""
    n = leaves[0].shape[0]
    cols = [t.contiguous().view(torch.uint8).reshape(n, -1)
            for t in leaves]
    return torch.cat(cols, dim=1) if len(cols) > 1 else cols[0].contiguous()


def row_bytes(like: Sequence[torch.Tensor]) -> List[int]:
    """Bytes per row of each leaf of a :func:`pack_rows` buffer."""
    return [math.prod(t.shape[1:]) * t.element_size() for t in like]


def unpack_rows(buf: torch.Tensor, like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Undo :func:`pack_rows`: leaves shaped and typed as ``like``'s
    trailing dims, with ``buf``'s row count."""
    n = buf.shape[0]
    out, col = [], 0
    for t, nb in zip(like, row_bytes(like)):
        part = buf[:, col:col + nb].clone()   # aligned for the view
        out.append(part.view(t.dtype).reshape((n,) + tuple(t.shape[1:])))
        col += nb
    return out


def broadcast_rows(leaves: Sequence[torch.Tensor], src: int,
                   like: Sequence[torch.Tensor], rows: int, device,
                   group=None, post: bool = True) -> List[torch.Tensor]:
    """``src``'s ``leaves`` ([rows, ...] each) on every rank of
    ``group``, moved as one byte buffer.  The other ranks pass ``like``
    (tensors with the leaves' trailing shapes and dtypes); ``src`` is the
    global rank.  Under a cost-ledger capture it records one broadcast of
    the buffer's bytes (``post``; ``gather_rows`` records its own)."""
    if dist.get_rank() == src:
        buf = pack_rows(list(leaves))
    else:
        buf = torch.empty((rows, sum(row_bytes(like))), dtype=torch.uint8,
                          device=device)
    if post:
        _collective("broadcast", buf.numel())
    else:
        check_collective_thread()
    dist.broadcast(buf, src=src, group=group)
    if dist.get_rank() == src:
        return list(leaves)
    return unpack_rows(buf, like)


def gather_rows(mesh: Mesh, local: Dict[str, torch.Tensor],
                counts: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Every rank's ``local`` leaves ([counts[rank], ...] each, the same
    names, trailing shapes and dtypes everywhere) concatenated in rank
    order on every rank: one byte broadcast per rank that holds rows,
    recorded under a cost-ledger capture as one all-gather of the
    gathered bytes."""
    if mesh.world == 1 or not mesh.distributed:
        return dict(local)
    names = list(local)
    like = [local[k] for k in names]
    _collective("all-gather", sum(counts) * sum(row_bytes(like)))
    parts: List[List[torch.Tensor]] = []
    for r, n in enumerate(counts):
        if n == 0:
            continue
        parts.append(broadcast_rows(like if r == mesh.rank else (), r,
                                    like, n, mesh.device, post=False))
    return {k: torch.cat([p[i] for p in parts]) if len(parts) > 1
            else parts[0][i] for i, k in enumerate(names)}


# ----------------------------------------------------------------- devices
def rank_devices(world: int, device="cuda",
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device of each rank: ``devices`` as given, else the CPU for
    every rank or one card per rank; a card run on a machine with fewer
    cards than ranks raises (it never moves to the CPU or onto a shared
    card by itself)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != world:
            raise ValueError(f"{len(devs)} devices for {world} ranks")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"ranks mix device types: {devs}")
        return devs
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * world
    have = torch.cuda.device_count()
    if have < world:
        raise ValueError(
            f"a mesh of {world} ranks needs {world} cards (one per rank), "
            f"this machine has {have}; for a dry run on the CPU pass "
            "--device cpu (gloo ranks)")
    return [torch.device("cuda", r) for r in range(world)]


def backend_for(devs: Sequence[torch.device]) -> str:
    """gloo for CPU ranks and for ranks sharing a card, NCCL for ranks on
    a card each."""
    if devs[0].type == "cpu":
        return "gloo"
    idx = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


def build_kernels_once(devs: Sequence[torch.device]) -> None:
    """Build or load every kernel library of the training path, one nvcc
    each, started together, before any rank starts (no-op on the CPU)."""
    if devs[0].type != "cuda":
        return
    from concurrent.futures import ThreadPoolExecutor

    from ..ops.gat_attention import gat_attention, gat_attention_backward
    from ..ops.substep import substep_megakernel

    ops = (gat_attention, gat_attention_backward, substep_megakernel)
    with ThreadPoolExecutor(len(ops)) as ex:
        for f in [ex.submit(op.library) for op in ops]:
            f.result()


# ------------------------------------------------------------------ launch
class RankFailed(RuntimeError):
    """A rank of a launch raised; the message holds its traceback."""


def _rank_main(fn, rank: int, dp: int, mp: int, device: str, backend: str,
               tmp: str, threads: int, fail: bool, args: tuple,
               t_spawn: float):
    out = os.path.join(tmp, f"rank{rank}")
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(tmp, "store"), dp * mp)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=dp * mp,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = carve(dp, mp, rank, dev, backend,
                     startup_s=time.time() - t_spawn)
        if fail:
            raise RuntimeError(f"injected failure in rank {rank} (the "
                               "launcher's fail_rank hook)")
        result = fn(mesh, *args)
        torch.save(result, out + ".tmp")
        os.replace(out + ".tmp", out + ".pt")
    except BaseException:
        # the process's boundary: the launcher reads the traceback and
        # reports it, and this process ends here
        with open(out + ".err.tmp", "w") as f:
            f.write(traceback.format_exc())
        os.replace(out + ".err.tmp", out + ".err")
        # the peers may wait in a collective: leave without tearing the
        # group down, the launcher kills them
        os._exit(1)
    dist.destroy_process_group()


def launch(fn: Callable, dp: int, mp: int = 1, device="cuda",
           devices: Optional[Sequence] = None,
           deadline_s: Optional[float] = None, args: tuple = (),
           fail_rank: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``dp * mp`` spawned ranks; returns each
    rank's result (saved with ``torch.save``: CPU tensors, dicts, lists).

    ``device`` "cpu" puts every rank on the CPU (gloo, one torch thread
    each); a card device puts one rank on each card
    (NCCL) and raises when the machine has fewer cards than ranks;
    ``devices`` names each rank's device outright (ranks sharing a card
    then use gloo).  ``fn`` must be importable by name (a module-level
    function).  The first failing rank's traceback is raised as
    :class:`RankFailed` after the other ranks are killed; past
    ``deadline_s`` seconds every rank is killed and ``TimeoutError`` is
    raised.  ``fail_rank`` (or ``GSC_MESH_FAIL_RANK``) makes that rank
    raise after it joined (the launcher's test hook)."""
    world = dp * mp
    devs = rank_devices(world, device, devices)
    backend = backend_for(devs)
    if fail_rank is None and os.environ.get(FAIL_RANK_ENV):
        fail_rank = int(os.environ[FAIL_RANK_ENV])
    # a fixed thread count per rank (matmul bits depend on it); card
    # ranks share the host's cores
    threads = (1 if devs[0].type == "cpu"
               else max(1, (os.cpu_count() or 1) // world))
    build_kernels_once(devs)
    tmp = tempfile.mkdtemp(prefix="gsc_mesh_")
    ctx = multiprocessing.get_context("spawn")
    t_spawn = time.time()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, dp, mp, str(devs[r]), backend, tmp, threads,
              fail_rank == r, args, t_spawn))
        for r in range(world)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        while True:
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    err = os.path.join(tmp, f"rank{r}.err")
                    tb = (open(err).read() if os.path.exists(err)
                          else f"exit code {p.exitcode}")
                    raise RankFailed(f"rank {r} of mesh {dp}x{mp} failed:"
                                     f"\n{tb}")
            if all(p.exitcode == 0 for p in procs):
                break
            if deadline_s is not None and \
                    time.perf_counter() - t0 > deadline_s:
                raise TimeoutError(
                    f"mesh {dp}x{mp} did not finish within {deadline_s} s; "
                    "every rank was killed")
            procs[0].join(0.05)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def init_distributed(dp: int, mp: int = 1, device=None) -> Mesh:
    """Join the ``torchrun`` environment this process was started in
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) as a rank of a ``dp x mp`` mesh: NCCL on card
    ``LOCAL_RANK``, or gloo on the CPU when ``device`` is "cpu"."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"not a torchrun environment: {missing} unset")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != dp * mp:
        raise ValueError(f"mesh {dp}x{mp} has {dp * mp} ranks, WORLD_SIZE "
                         f"is {world}")
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        dev, backend = torch.device("cuda", local), "nccl"
        torch.cuda.set_device(dev)
    t0 = time.time()
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return carve(dp, mp, rank, dev, backend, startup_s=time.time() - t0)


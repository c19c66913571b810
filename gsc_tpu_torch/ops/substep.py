"""The simulator substep megakernel: a hand-written CUDA kernel and its
plain PyTorch version.

The kernel (``csrc/substep_megakernel.cu``) replaces the TPU kernel
``gsc_tpu/ops/pallas_substep.py::substep_megakernel``; its header says
what bounds it on the card and how its design answers that.  One launch
runs ``substeps`` substeps (a whole control interval) of every replica:
one CTA per replica, one thread per flow slot, the flow table and the
replica's small tables in shared memory.  Every stage is parallel over
slots or sorted positions: ranks and lists are warp ballots, the sorted
groups come from count-ranking, the link and node admission rounds are
block-wide double scans that are bit-equal to the plain version's
sequential cumsum whenever a round's values span at most 53 bits (a
round that spans more runs the sequential scan in the kernel and is
counted in ``serial_rounds``), and scatter-adds go by target in slot
order.  It is compiled with ``nvcc`` for ``sm_90a`` (with
``-fmad=false``: the plain version rounds a product and a sum apart) at
first use into ``gsc_tpu_torch/_build/`` and bound with ``ctypes``
through a plain C interface that takes one struct of pointers and sizes.

``substep_megakernel(engine, state, topo, traffic, cap_now, noise,
substeps, ext_decisions)`` dispatches on where the state lies: CUDA
tensors launch the kernel (or raise on what it does not take), CPU
tensors run ``substep_plain``, the engine's plain substep repeated.  There
is no fallback from the kernel to the plain version.  The state it
returns is new: the kernel updates clones of the mutable fields in place.
Per-flow control is a mode of the same kernel with two switches:
``ext_decisions`` [B, M] i32 (one substep per launch) replaces the WRR by
external decisions with place-on-decision, and a configuration with
``controller == "per_flow"`` removes idle instances after
``vnf_timeout`` (also in a duration-style ``apply``).
Resource-function plugins (``config.registry``) run inside the kernel:
``ops.resource_codegen`` turns the engine's plugins into a generated
header of CUDA device functions (ids from 2 up), and the wrapper builds
one library per distinct header, cached in ``_build/`` by its digest, at
the first launch that needs it (``plugin_build_s`` keeps each build's
seconds); a plugin with an operation outside the compiled set raises,
naming it, and never runs in the plain engine instead.  Without plugins
the library is the kernel's own build.
``substep_megakernel.launches`` counts the launches without external
decisions and without plugins, ``substep_megakernel.perflow_launches``
those with external decisions, ``substep_megakernel.plugin_launches``
those of a plugin build (either mode), and
``substep_megakernel.serial_rounds`` the admission rounds that took the
sequential scan (reading it synchronises; assigning 0 resets it).
``SubstepMegakernel(stage_clocks=True)`` builds the same source with
``-DSUBSTEP_STAGE_CLOCKS`` for timing: each launch leaves clock64()
cycles per stage ``STAGES`` and replica in ``stage_clocks``.
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import upload
from ..sim.state import SimState, TrafficSchedule
from ..topology.compiler import Topology
from .build import MAX_SMEM_BYTES, PKG, build_library
from .cost import posted, substep_launch_parts
from .resource_codegen import HEADER_NAME, kernel_plan

SOURCE = PKG / "csrc" / "substep_megakernel.cu"
EXTRA_FLAGS = ("-fmad=false",)
MAX_FLOWS = 1024
# bits of a double's significand (the kernel's DOUBLE_BITS)
DOUBLE_BITS = 53
# the stages a SUBSTEP_STAGE_CLOCKS build times, in the kernel's order
STAGES = ("releases+timers", "arrivals", "decisions", "wrr", "forwarding",
          "grouping", "admission scans", "admission tests", "slot results",
          "ring adds", "scatters+sums")

_DIMS = ("B", "M", "N", "C", "S", "P", "E", "H", "F", "K", "R", "iters")
_STRIDES = ("topo_nn_stride", "topo_e_stride", "traf_stride")
_STATE = ("t", "cursor", "truncated_arrivals")
_FLOWS = ("phase", "sfc", "position", "node", "dest", "hop_next", "egress",
          "dr", "duration", "ttl", "e2e", "pend_path", "timer")
_TABLES = ("node_load", "sf_available", "sf_startup", "sf_last_active",
           "placed", "schedule", "edge_used", "rel_node", "rel_edge")
_METRICS = ("generated", "processed", "dropped", "active", "drop_reasons",
            "sum_proc_delay", "num_proc_delay", "sum_path_delay",
            "num_path_delay", "sum_e2e", "run_generated", "run_processed",
            "run_dropped", "run_dropped_per_node", "run_e2e_sum",
            "run_e2e_max", "run_path_delay_sum", "run_requested",
            "run_requested_node", "run_processed_traffic",
            "run_flow_counts", "run_max_node_usage", "run_passed_traffic")
_TOPO = ("path_delay", "next_hop", "adj_edge_id", "edge_cap", "edge_delay")
# the kernel reads each group's tables with one per-replica stride
_TOPO_GROUPS = {"topo_nn_stride": _TOPO[:3], "topo_e_stride": _TOPO[3:]}
_TRAFFIC = ("arr_time", "arr_ingress", "arr_dr", "arr_duration", "arr_ttl",
            "arr_sfc", "arr_egress")
_EXTRA = ("cap_now", "noise", "chain_len", "chain_sf", "proc", "rf_id")
# the kernel's own outputs: the serial-round counter, the stage clocks
_COUNTERS = ("serial_rounds", "stage_clocks")
# per-flow control, at the struct's end
_PERFLOW = (("ext_decisions", ctypes.c_void_p), ("gc", ctypes.c_longlong),
            ("vnf_timeout", ctypes.c_double))
# state fields the duration controller's substep never writes: passed as
# they are, not cloned (place-on-decision writes the first two, the idle
# expiry the second)
_READ_ONLY = ("sf_startup", "placed", "schedule")

# request pools and a trainer may launch from threads of their own
_COUNT_LOCK = threading.Lock()


class SubstepArgs(ctypes.Structure):
    """Mirror of ``struct SubstepArgs`` in the CUDA source: every field 8
    bytes, in the same order (``substep_args_size()`` checks the size)."""

    _fields_ = ([(n, ctypes.c_longlong) for n in _DIMS]
                + [("dt", ctypes.c_double)]
                + [(n, ctypes.c_longlong) for n in _STRIDES]
                + [(n, ctypes.c_void_p) for n in _STATE + _FLOWS + _TABLES
                   + _METRICS + _TOPO + _TRAFFIC + _EXTRA + _COUNTERS]
                  + list(_PERFLOW))


def substep_plain(engine, state: SimState, topo: Topology,
                  traffic: TrafficSchedule, cap_now: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  substeps: Optional[int] = None,
                  ext_decisions: Optional[torch.Tensor] = None) -> SimState:
    """The kernel's plain PyTorch version: the engine's plain substep
    (``SimEngine.substep``) ``substeps`` times; ``noise`` [B, substeps, M]
    or None, ``ext_decisions`` [B, M] or None.  ``topo``/``traffic`` carry
    the batch dim."""
    k_n = engine.substeps if substeps is None else substeps
    for k in range(k_n):
        state = engine.substep(state, topo, traffic, cap_now,
                               None if noise is None else noise[:, k],
                               ext_decisions)
    return state


def scan_order_free(values) -> bool:
    """The kernel's exactness test of one admission round, in Python: True
    when every partial sum of the nonzero f32 ``values``, in any
    association, is exact in a double, so that the kernel's tree scan
    equals the plain version's sequential double cumsum bit for bit.
    With lo the smallest exponent of a lowest set bit, top the largest
    floor(log2|v|) and n the count of nonzero values, that holds when
    top + 1 + ceil(log2 n) - lo <= 53.  False on a non-finite value."""
    bits = np.asarray(values, dtype=np.float32).ravel().view(np.uint32)
    lo, top, n = None, None, 0
    for u in (int(x) & 0x7FFFFFFF for x in bits):
        if u == 0:
            continue
        e, man = u >> 23, u & 0x7FFFFF
        if e == 255:
            return False
        if e == 0:
            v_lo = -149 + ((man & -man).bit_length() - 1)
            v_top = -149 + man.bit_length() - 1
        else:
            full = man | 0x800000
            v_lo = e - 150 + ((full & -full).bit_length() - 1)
            v_top = e - 127
        lo = v_lo if lo is None else min(lo, v_lo)
        top = v_top if top is None else max(top, v_top)
        n += 1
    if n == 0:
        return True
    return top + 1 + (n - 1).bit_length() - lo <= DOUBLE_BITS


def _per_replica(t: torch.Tensor, batch: int, name: str):
    """(contiguous tensor, per-replica element stride): a table shared by
    every replica (an expanded view) passes once with stride 0."""
    if t.shape[0] != batch:
        raise ValueError(f"substep_megakernel: {name} has leading dim "
                         f"{t.shape[0]}, want the batch {batch}")
    if t.stride(0) == 0:
        return t[0].contiguous(), 0
    t = t.contiguous()
    return t, t[0].numel()


def resource_plan(engine, dev) -> Dict:
    """The kernel's resource-function ids of the engine's SF columns (i32
    on ``dev``) and the plugin header (None without plugins), made once
    per engine and device; raises ``UnsupportedResourceFunction`` for a
    plugin the kernel cannot run."""
    tabs = engine._tab(dev)
    if "rf_id" not in tabs:
        ids, header = kernel_plan(engine.tables.resource_fns)
        tabs["rf_header"] = header
        tabs["rf_id"] = upload(ids, torch.int32, dev)
    return tabs


class SubstepMegakernel:
    """Callable wrapper around the kernel: builds and loads the library on
    first CUDA use, validates arguments, launches on the current stream and
    counts launches in ``launches``.  With ``stage_clocks`` it builds the
    clocked variant and keeps each launch's [B, len(STAGES)] cycles in
    ``stage_clocks``."""

    def __init__(self, stage_clocks: bool = False):
        self.launches = 0
        self.perflow_launches = 0
        self.plugin_launches = 0
        self.build_log = ""
        self.clocked = stage_clocks
        self.stage_clocks: Optional[torch.Tensor] = None
        self._lib = None
        # plugin builds by header text; each one's build seconds and log
        self._plugin_libs: Dict[str, ctypes.CDLL] = {}
        self.plugin_build_s: Dict[str, float] = {}
        self.plugin_build_log: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._build_locks: Dict[Optional[str], threading.Lock] = {}
        self._serial = {}

    @property
    def serial_rounds(self) -> int:
        """Admission rounds that ran the sequential scan since the last
        reset, over every launch and replica (synchronises the card)."""
        return sum(int(t.item()) for t in self._serial.values())

    @serial_rounds.setter
    def serial_rounds(self, value: int):
        if value != 0:
            raise ValueError("serial_rounds can only be reset to 0")
        for t in self._serial.values():
            t.zero_()

    def library(self, plugins: Optional[str] = None) -> ctypes.CDLL:
        """Build (once per digest of source and ``plugins``, the generated
        header) and load the shared library; two builds run at once."""
        with self._lock:
            lock = self._build_locks.setdefault(plugins, threading.Lock())
        with lock:
            if plugins is not None:
                lib = self._plugin_libs.get(plugins)
                if lib is None:
                    t0 = time.perf_counter()
                    lib, log = build_library(
                        SOURCE, self._flags() + ("-DSUBSTEP_RF_PLUGINS",),
                        generated={HEADER_NAME: plugins})
                    self._bind(lib)
                    self.plugin_build_s[plugins] = time.perf_counter() - t0
                    self.plugin_build_log[plugins] = log
                    self._plugin_libs[plugins] = lib
                return lib
            if self._lib is None:
                lib, self.build_log = build_library(SOURCE, self._flags())
                self._bind(lib)
                self._lib = lib
            return self._lib

    def _flags(self):
        return EXTRA_FLAGS + (("-DSUBSTEP_STAGE_CLOCKS",)
                              if self.clocked else ())

    def _bind(self, lib: ctypes.CDLL):
        """Declare the C interface and check it against the wrapper."""
        lib.substep_megakernel.argtypes = [ctypes.POINTER(SubstepArgs),
                                           ctypes.c_void_p]
        lib.substep_megakernel.restype = ctypes.c_int
        lib.substep_args_size.restype = ctypes.c_longlong
        lib.substep_smem_bytes.argtypes = [ctypes.POINTER(SubstepArgs)]
        lib.substep_smem_bytes.restype = ctypes.c_longlong
        lib.substep_n_stages.restype = ctypes.c_int
        lib.substep_error_string.argtypes = [ctypes.c_int]
        lib.substep_error_string.restype = ctypes.c_char_p
        size = lib.substep_args_size()
        if size != ctypes.sizeof(SubstepArgs):
            raise RuntimeError(
                f"SubstepArgs is {size} bytes in the kernel and "
                f"{ctypes.sizeof(SubstepArgs)} in the wrapper")
        stages = lib.substep_n_stages()
        if stages != (len(STAGES) if self.clocked else 0):
            raise RuntimeError(f"the library times {stages} stages, "
                               f"the wrapper names {len(STAGES)}")

    def __call__(self, engine, state: SimState, topo: Topology,
                 traffic: TrafficSchedule, cap_now: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 substeps: Optional[int] = None,
                 ext_decisions: Optional[torch.Tensor] = None) -> SimState:
        if state.t.device.type == "cpu":
            with posted("substep_megakernel", substep_launch_parts, engine,
                        state, traffic, substeps, ext_decisions):
                return substep_plain(engine, state, topo, traffic, cap_now,
                                     noise, substeps, ext_decisions)
        return self.launch(engine, state, topo, traffic, cap_now, noise,
                           substeps, ext_decisions)

    def launch(self, engine, state: SimState, topo: Topology,
               traffic: TrafficSchedule, cap_now: torch.Tensor,
               noise: Optional[torch.Tensor] = None,
               substeps: Optional[int] = None,
               ext_decisions: Optional[torch.Tensor] = None) -> SimState:
        """Run ``substeps`` substeps (default: the engine's interval, 1
        with ``ext_decisions``) of every replica on CUDA tensors; raises
        on anything the kernel does not take."""
        dev = state.t.device
        if dev.type != "cuda":
            raise ValueError(f"substep_megakernel: the state is on {dev}; "
                             "the kernel takes CUDA tensors")
        with posted("substep_megakernel", substep_launch_parts, engine,
                    state, traffic, substeps, ext_decisions):
            return self._launch(engine, state, topo, traffic, cap_now, noise,
                                substeps, ext_decisions)

    def _launch(self, engine, state, topo, traffic, cap_now, noise,
                substeps, ext_decisions):
        dev = state.t.device
        counter = self._serial.get(dev)
        if counter is None:
            counter = self._serial[dev] = torch.zeros(1, dtype=torch.int64,
                                                      device=dev)
        clocks = None
        if self.clocked:
            clocks = torch.zeros(state.batch, len(STAGES), dtype=torch.int64,
                                 device=dev)
        args, new_state = self._prepare(engine, state, topo, traffic,
                                        cap_now, noise, substeps, counter,
                                        clocks, ext_decisions)
        plugins = engine._tab(dev)["rf_header"]
        lib = self.library(plugins)
        smem = lib.substep_smem_bytes(ctypes.byref(args))
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"substep_megakernel: M={engine.M}, "
                             f"P={engine.P} need {smem} bytes of shared "
                             f"memory, more than a block's {MAX_SMEM_BYTES}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            code = lib.substep_megakernel(ctypes.byref(args), stream)
        if code != 0:
            raise RuntimeError(
                "substep_megakernel launch failed: "
                f"{lib.substep_error_string(code).decode()} ({code})")
        with _COUNT_LOCK:
            if plugins is not None:
                self.plugin_launches += 1
            elif ext_decisions is None:
                self.launches += 1
            else:
                self.perflow_launches += 1
        self.stage_clocks = clocks
        return new_state

    def _prepare(self, engine, state: SimState, topo: Topology,
                 traffic: TrafficSchedule, cap_now: torch.Tensor,
                 noise: Optional[torch.Tensor], substeps: Optional[int],
                 serial_rounds: torch.Tensor,
                 stage_clocks: Optional[torch.Tensor],
                 ext_decisions: Optional[torch.Tensor] = None):
        """Validate the inputs and build the kernel's arguments over clones
        of the mutable state (on the state's device, whatever it is);
        returns (SubstepArgs, the state the launch fills in)."""
        dev = state.t.device
        b = state.batch
        cfg = engine.cfg
        if substeps is None:
            substeps = 1 if ext_decisions is not None else engine.substeps
        k_n = int(substeps)
        if engine.M > MAX_FLOWS:
            raise ValueError(f"substep_megakernel: {engine.M} flow slots, "
                             f"the kernel takes at most {MAX_FLOWS} (one "
                             "thread per slot)")
        # the idle expiry runs under per-flow control, decided or not
        gc = cfg.controller == "per_flow"
        if ext_decisions is not None:
            if k_n != 1:
                raise ValueError("substep_megakernel: external decisions "
                                 f"take one substep per launch, not {k_n}")
            if tuple(ext_decisions.shape) != (b, engine.M) \
                    or ext_decisions.dtype != torch.int32:
                raise ValueError(
                    "substep_megakernel: ext_decisions must be [B, M] = "
                    f"{(b, engine.M)} int32, got "
                    f"{tuple(ext_decisions.shape)} {ext_decisions.dtype}")
        if engine.det_proc:
            noise = None
        elif noise is None or tuple(noise.shape) != (b, k_n, engine.M):
            raise ValueError(
                f"substep_megakernel: stochastic processing delays need "
                f"noise [B, substeps, M] = {(b, k_n, engine.M)}, got "
                f"{None if noise is None else tuple(noise.shape)}")
        tabs = resource_plan(engine, dev)

        fresh = lambda t: t.clone(memory_format=torch.contiguous_format)
        writes = set()
        if ext_decisions is not None:
            writes |= {"sf_startup", "placed"}
        if gc:
            writes.add("placed")
        new = {}
        for name in _STATE + _TABLES:
            t = getattr(state, name)
            new[name] = (t.contiguous()
                         if name in _READ_ONLY and name not in writes
                         else fresh(t))
        flows = state.flows.map(fresh)
        metrics = state.metrics.map(fresh)
        ptr = {}
        for name in _STATE + _TABLES:
            ptr[name] = new[name]
        for name in _FLOWS:
            ptr[name] = getattr(flows, name)
        for name in _METRICS:
            ptr[name] = getattr(metrics, name)
        topo_b = topo.expand(b)
        traffic_b = traffic.expand(b)
        strides = {}
        for group, names in _TOPO_GROUPS.items():
            # one stride per group: a table shared by every replica is
            # made per replica when another table of its group is (a
            # link-fault row of edge capacities beside shared delays)
            group_tabs = [getattr(topo_b, n) for n in names]
            if any(t.stride(0) != 0 for t in group_tabs):
                group_tabs = [t.contiguous() for t in group_tabs]
            for name, tab in zip(names, group_tabs):
                ptr[name], strides[group] = _per_replica(tab, b, name)
        traf_strides = set()
        for name in _TRAFFIC:
            t, s = _per_replica(getattr(traffic_b, name), b, name)
            ptr[name] = t
            traf_strides.add(s)
        if len(traf_strides) != 1:
            raise ValueError("substep_megakernel: traffic arrays must all be "
                             "shared or all be per replica")
        strides["traf_stride"] = traf_strides.pop()
        ptr["cap_now"] = cap_now.contiguous()
        ptr["noise"] = None if noise is None else noise.contiguous()
        ptr["chain_len"] = tabs["chain_len"]
        ptr["chain_sf"] = tabs["chain_sf"]
        ptr["proc"] = tabs["proc"].contiguous()
        ptr["rf_id"] = tabs["rf_id"]
        ptr["serial_rounds"] = serial_rounds
        ptr["stage_clocks"] = stage_clocks
        ptr["ext_decisions"] = (None if ext_decisions is None
                                else ext_decisions.contiguous())
        want = {torch.float32: "f32", torch.int32: "i32", torch.bool: "bool",
                torch.int64: "i64"}
        for name, t in ptr.items():
            if t is None:
                continue
            if t.device != dev:
                raise ValueError(f"substep_megakernel: {name} is on "
                                 f"{t.device}, the state on {dev}")
            if t.dtype not in want:
                raise TypeError(f"substep_megakernel: {name} is {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"substep_megakernel: {name} is not "
                                 "contiguous")
        for name in ("dr", "ttl", "t", "node_load", "arr_time", "path_delay",
                     "cap_now", "proc"):
            if ptr[name].dtype != torch.float32:
                raise TypeError(f"substep_megakernel: {name} is "
                                f"{ptr[name].dtype}, the kernel takes f32")
        for name in ("phase", "cursor", "next_hop", "arr_ingress",
                     "run_flow_counts"):
            if ptr[name].dtype != torch.int32:
                raise TypeError(f"substep_megakernel: {name} is "
                                f"{ptr[name].dtype}, the kernel takes i32")
        for name in ("sf_available", "placed"):
            if ptr[name].dtype != torch.bool:
                raise TypeError(f"substep_megakernel: {name} is "
                                f"{ptr[name].dtype}, the kernel takes bool")
        args = SubstepArgs(
            B=b, M=engine.M, N=engine.N, C=engine.C, S=engine.S, P=engine.P,
            E=engine.E, H=engine.H, F=traffic.capacity, K=k_n,
            R=cfg.wrr_rank_levels, iters=cfg.admission_iters, dt=engine.dt,
            gc=int(gc), vnf_timeout=cfg.vnf_timeout, **strides,
            **{name: (None if t is None else t.data_ptr())
               for name, t in ptr.items()})
        return args, state.replace(flows=flows, metrics=metrics,
                                   **{n: new[n] for n in _STATE + _TABLES})


substep_megakernel = SubstepMegakernel()

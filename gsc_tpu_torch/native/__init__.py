"""The host traffic sampler in C++ (``traffic_gen.cpp``), loaded with ctypes.

The port's copy of the JAX package's native sampler: the same source
(only its header comment differs), the same ``g++ -O2 -shared -fPIC``
build and the same C interface, so one seed gives the same flows in both
packages.  ``std::mt19937_64`` and the ``std::`` distributions are defined
by the C++ standard library, not by the compiler's optimiser, so two
builds by one toolchain draw the same numbers.

The library is built with g++ at first use into ``gsc_tpu_torch/_build/``
(one file per digest of source and flags, written atomically, so several
processes may build it at once) and reported to the compile monitor
(``ops.build.add_build_hook``: ``traffic_gen_<digest>``, stages ``build``
and ``load``), as the kernel libraries are.

There is no silent fallback: when the build or the load fails,
:func:`load_library` raises :class:`NativeBuildError` with the compiler's
output.  The numpy path of ``sim.traffic`` is chosen only by
``GSC_TPU_NO_NATIVE=1``, the variable the JAX package reads, so that one
switch picks the same path in both packages.  It is read at every call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.build import BUILD_DIR, notify_build

SOURCE = Path(__file__).resolve().with_name("traffic_gen.cpp")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
SWITCH = "GSC_TPU_NO_NATIVE"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native traffic sampler could not be built or loaded."""


def native_disabled() -> bool:
    """True when ``GSC_TPU_NO_NATIVE=1`` picks the numpy path."""
    return os.environ.get(SWITCH) == "1"


def library_path() -> Path:
    """The build's file: named by a digest of the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCE.stem}_{digest}.so"


def _build(so: Path) -> None:
    cxx = shutil.which(CXX)
    if cxx is None:
        raise NativeBuildError(
            f"{CXX} not found on PATH: it builds the native traffic sampler "
            f"({SOURCE}); set {SWITCH}=1 to sample with numpy instead")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{CXX} failed ({res.returncode}) building {SOURCE}:\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    notify_build(so.stem, "build", time.perf_counter() - t0)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gsc_generate_flows.restype = ctypes.c_int
    lib.gsc_generate_flows.argtypes = [
        ctypes.c_uint64,
        ctypes.c_int, ctypes.c_double,
        ctypes.c_int, dp,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        dp, ctypes.c_int,
        ctypes.c_int,
        ip, ctypes.c_int,
        ctypes.c_int,
        dp, ip, dp, dp, dp, ip, ip,
    ]
    return lib


def load_library() -> ctypes.CDLL:
    """The sampler's library, built on first use; raises
    :class:`NativeBuildError` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            t0 = time.perf_counter()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise NativeBuildError(f"cannot load {so}: {e}") from e
            notify_build(so.stem, "load", time.perf_counter() - t0)
            _lib = _bind(lib)
    return _lib


def generate_flows_native(seed: int, means: np.ndarray, run_duration: float,
                          dr_mean: float, dr_stdev: float, size_shape: float,
                          det_arrival: bool, det_size: bool,
                          ttl_choices: np.ndarray, n_sfcs: int,
                          egress_nodes: np.ndarray, capacity: int
                          ) -> Tuple[np.ndarray, ...]:
    """One episode's flows from ``means`` ([steps, nodes] arrival means,
    NaN where an ingress is off): (times, ingress, drs, durs, ttls, sfcs,
    egs), each of the number of flows kept (at most ``capacity``), sorted
    by arrival time."""
    lib = load_library()
    steps, n_nodes = means.shape
    means = np.ascontiguousarray(means, np.float64)
    ttl = np.ascontiguousarray(ttl_choices, np.float64)
    eg = np.ascontiguousarray(egress_nodes, np.int32)
    times = np.empty(capacity, np.float64)
    ingress = np.empty(capacity, np.int32)
    drs = np.empty(capacity, np.float64)
    durs = np.empty(capacity, np.float64)
    ttls = np.empty(capacity, np.float64)
    sfcs = np.empty(capacity, np.int32)
    egs = np.empty(capacity, np.int32)

    def pd(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def pi(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    n = lib.gsc_generate_flows(
        ctypes.c_uint64(int(seed)), steps, run_duration, n_nodes, pd(means),
        dr_mean, dr_stdev, size_shape, int(det_arrival), int(det_size),
        pd(ttl), len(ttl), n_sfcs, pi(eg), len(eg), capacity,
        pd(times), pi(ingress), pd(drs), pd(durs), pd(ttls), pi(sfcs),
        pi(egs))
    return (times[:n], ingress[:n], drs[:n], durs[:n], ttls[:n], sfcs[:n],
            egs[:n])


__all__ = ["CXX", "CXX_FLAGS", "NativeBuildError", "SOURCE", "SWITCH",
           "generate_flows_native", "library_path", "load_library",
           "native_disabled"]

"""Build and load a kernel library: ``nvcc`` for ``sm_90a`` into
``gsc_tpu_torch/_build/`` (one shared library per digest of source,
headers and flags), loaded with ``ctypes`` through its plain C
interface.  Generated headers (kernel #2's resource-function plugins) are
written beside the library and put on the include path.  Every build and
every load is reported to the hooks of ``add_build_hook`` (the compile
monitor's ``compile`` events)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a block's dynamic shared-memory ceiling on Hopper (227 KB)
MAX_SMEM_BYTES = 232448


# observers of builds and loads (analysis.sentinels.CompileMonitor): each
# is called with (library, stage "build" or "load", seconds) from the
# thread that built or loaded it
_HOOKS: List[Callable[[str, str, float], None]] = []
_HOOKS_LOCK = threading.Lock()


def add_build_hook(fn: Callable[[str, str, float], None]) -> None:
    with _HOOKS_LOCK:
        _HOOKS.append(fn)


def remove_build_hook(fn: Callable[[str, str, float], None]) -> None:
    with _HOOKS_LOCK:
        if fn in _HOOKS:
            _HOOKS.remove(fn)


def notify_build(library: str, stage: str, seconds: float) -> None:
    """Tell every hook that ``library`` was built or loaded."""
    with _HOOKS_LOCK:
        hooks = list(_HOOKS)
    for fn in hooks:
        fn(library, stage, seconds)


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc) to "
                           "build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_digest(source: Path, flags: Sequence[str],
                   generated: Optional[Dict[str, str]] = None) -> str:
    """The digest naming a build: the source, the ``*.cuh`` headers beside
    it (part of what it compiles), the generated headers and the
    flags."""
    headers = b"".join(h.read_bytes()
                       for h in sorted(source.parent.glob("*.cuh")))
    gen = b"".join(f"{name}\0{text}\0".encode()
                   for name, text in sorted((generated or {}).items()))
    return hashlib.sha256(source.read_bytes() + headers + gen
                          + " ".join(flags).encode()).hexdigest()[:16]


def _write_atomic(path: Path, text: str):
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}"
                         ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def build_library(source: Path, extra_flags: Sequence[str] = (),
                  generated: Optional[Dict[str, str]] = None
                  ) -> Tuple[ctypes.CDLL, str]:
    """Compile ``source`` once per digest and load it; returns the library
    and the compiler's log (ptxas registers and spills) of a fresh build,
    or "" when the library was already built.  ``generated`` maps header
    names to their text: they are part of the digest and are written to
    a directory on the include path of this build."""
    flags = tuple(NVCC_FLAGS) + tuple(extra_flags)
    digest = library_digest(source, flags, generated)
    so = BUILD_DIR / f"{source.stem}_{digest}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        include = []
        if generated:
            inc = BUILD_DIR / f"{source.stem}_{digest}_include"
            inc.mkdir(exist_ok=True)
            for name, text in generated.items():
                _write_atomic(inc / name, text)
            include = ["-I", str(inc)]
        # one temporary per process and thread: two threads may build the
        # same library at once
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                           ".tmp")
        cmd = [nvcc(), *flags, *include, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {source}:\n"
                f"{res.stdout}\n{res.stderr}")
        log = res.stderr
        os.replace(tmp, so)
        notify_build(so.stem, "build", time.perf_counter() - t0)
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(so))
    notify_build(so.stem, "load", time.perf_counter() - t0)
    return lib, log

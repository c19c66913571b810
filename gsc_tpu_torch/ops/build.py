"""Build and load a kernel library: ``nvcc`` for ``sm_90a`` into
``gsc_tpu_torch/_build/`` (one shared library per digest of source and
flags), loaded with ``ctypes`` through its plain C interface."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a block's dynamic shared-memory ceiling on Hopper (227 KB)
MAX_SMEM_BYTES = 232448


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc) to "
                           "build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library(source: Path, extra_flags: Sequence[str] = ()
                  ) -> Tuple[ctypes.CDLL, str]:
    """Compile ``source`` once per digest and load it; returns the library
    and the compiler's log (ptxas registers and spills) of a fresh build,
    or "" when the library was already built."""
    flags = tuple(NVCC_FLAGS) + tuple(extra_flags)
    # the headers beside the source are part of what it compiles
    headers = b"".join(h.read_bytes()
                       for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}_{digest}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # one temporary per process and thread: two threads may build the
        # same library at once
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}"
                           ".tmp")
        cmd = [nvcc(), *flags, "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {source}:\n"
                f"{res.stdout}\n{res.stderr}")
        log = res.stderr
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log

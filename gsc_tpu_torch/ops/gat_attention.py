"""The fused GATv2 attention stage: a hand-written CUDA kernel and its plain
PyTorch version.

The kernel (``csrc/gat_attention.cu``) replaces the TPU kernel
``gsc_tpu/ops/pallas_gat.py::_gat_kernel``; its header says what bounds it
on the card and how its design answers that.  It is compiled with ``nvcc``
for ``sm_90a`` from the repository's source at first use, into
``gsc_tpu_torch/_build/`` (one shared library per source digest), and
bound with ``ctypes`` through a plain C interface.

``gat_attention(xl, xr, att, bias, adj, mean_aggr)`` dispatches on where
the tensors lie: CUDA tensors launch the kernel (or raise on what it does
not take), CPU tensors run ``attention_plain``.  There is no fallback from
the kernel to the plain version.  ``gat_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
import torch

from .gat import attention_dense

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "gat_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a block's dynamic shared-memory ceiling on Hopper (227 KB)
MAX_SMEM_BYTES = 232448


# the kernel's plain PyTorch version: the dense masked attention
attention_plain = attention_dense


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc) to "
                           "build the attention kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class GatAttention:
    """Callable wrapper around the kernel: builds and loads the library on
    first CUDA use, validates arguments, launches on the current stream and
    counts launches in ``launches``."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- build
    def library(self) -> ctypes.CDLL:
        """Build (once per source digest) and load the shared library."""
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
            return self._lib

    def _build_and_load(self) -> ctypes.CDLL:
        src = SOURCE.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
        so = BUILD_DIR / f"gat_attention_{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) building {SOURCE}:\n"
                    f"{res.stdout}\n{res.stderr}")
            self.build_log = res.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gat_attention_f32.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                          ci, vp]
        lib.gat_attention_f32.restype = ci
        lib.gat_attention_smem_bytes.argtypes = [ci, ci]
        lib.gat_attention_smem_bytes.restype = ctypes.c_longlong
        lib.gat_attention_error_string.argtypes = [ci]
        lib.gat_attention_error_string.restype = ctypes.c_char_p
        return lib

    # ------------------------------------------------------------ launch
    def __call__(self, xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor,
                 bias: torch.Tensor, adj: torch.Tensor,
                 mean_aggr: bool = True) -> torch.Tensor:
        """xl, xr [..., N, F] f32; att, bias [F]; adj [..., N, N] bool."""
        if xl.device.type == "cpu":
            return attention_plain(xl, xr, att, bias, adj, mean_aggr)
        return self.launch(xl, xr, att, bias, adj, mean_aggr)

    def launch(self, xl, xr, att, bias, adj, mean_aggr: bool = True
               ) -> torch.Tensor:
        """Run the kernel on CUDA tensors; raises on anything it does not
        take."""
        n, f = xl.shape[-2], xl.shape[-1]
        lead = xl.shape[:-2]
        args = {"xl": xl, "xr": xr, "att": att, "bias": bias, "adj": adj}
        for name, t in args.items():
            if t.device != xl.device or t.device.type != "cuda":
                raise ValueError(f"gat_attention: {name} is on {t.device}, "
                                 f"xl on {xl.device}; the kernel takes CUDA "
                                 "tensors on one device")
            if not t.is_contiguous():
                raise ValueError(f"gat_attention: {name} is not contiguous")
        for name in ("xl", "xr", "att", "bias"):
            if args[name].dtype != torch.float32:
                raise TypeError(f"gat_attention: {name} is "
                                f"{args[name].dtype}, the kernel takes f32")
        if adj.dtype != torch.bool:
            raise TypeError(f"gat_attention: adj is {adj.dtype}, want bool")
        if xr.shape != xl.shape or att.shape != (f,) or bias.shape != (f,) \
                or adj.shape != lead + (n, n):
            raise ValueError(
                f"gat_attention: shapes xl {tuple(xl.shape)}, xr "
                f"{tuple(xr.shape)}, att {tuple(att.shape)}, bias "
                f"{tuple(bias.shape)}, adj {tuple(adj.shape)} do not match")
        if n < 1 or f < 1:
            raise ValueError(f"gat_attention: empty graph shape N={n} F={f}")
        lib = self.library()
        smem = lib.gat_attention_smem_bytes(n, f)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"gat_attention: N={n}, F={f} needs {smem} bytes of shared "
                f"memory, more than a block's {MAX_SMEM_BYTES}")
        b = 1
        for d in lead:
            b *= d
        out = torch.empty_like(xl)
        stream = torch.cuda.current_stream(xl.device).cuda_stream
        with torch.cuda.device(xl.device):
            code = lib.gat_attention_f32(
                xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                bias.data_ptr(), adj.data_ptr(), out.data_ptr(), b, n, f,
                int(bool(mean_aggr)), stream)
        if code != 0:
            raise RuntimeError(
                "gat_attention kernel launch failed: "
                f"{lib.gat_attention_error_string(code).decode()} ({code})")
        self.launches += 1
        return out


gat_attention = GatAttention()

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
not take) through a ``torch.autograd.Function`` whose backward is the
plain dense VJP (no backward kernel), CPU tensors run ``attention_plain``,
which autograd differentiates itself.  There is no fallback from
the kernel to the plain version.  ``gat_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .build import MAX_SMEM_BYTES, PKG, build_library
from .gat import attention_dense

SOURCE = PKG / "csrc" / "gat_attention.cu"


# the kernel's plain PyTorch version: the dense masked attention
attention_plain = attention_dense


class _GatAttentionFn(torch.autograd.Function):
    """The kernel with a gradient.  The forward launches the kernel; the
    backward is the plain dense formulation's VJP (``attention_plain``
    recomputed under ``enable_grad`` and differentiated by autograd), the
    port's form of the JAX package's ``_gatv2_pallas_bwd``, which also
    takes the dense VJP.  The backward launches no kernel."""

    @staticmethod
    def forward(ctx, op, xl, xr, att, bias, adj, mean_aggr):
        ctx.save_for_backward(xl, xr, att, bias, adj)
        ctx.mean_aggr = mean_aggr
        return op.launch(xl, xr, att, bias, adj, mean_aggr)

    @staticmethod
    def backward(ctx, grad_out):
        xl, xr, att, bias, adj = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True)
                   for t in (xl, xr, att, bias)]
            out = attention_plain(*ins, adj, ctx.mean_aggr)
            grads = torch.autograd.grad(out, ins, grad_out)
        return (None, *grads, None, None)


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
        lib, self.build_log = build_library(SOURCE)
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
        return _GatAttentionFn.apply(self, xl, xr, att, bias, adj,
                                     bool(mean_aggr))

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

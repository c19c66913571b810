"""The fused GATv2 attention stage: hand-written CUDA kernels for its
forward and its gradient, in f32 and in bf16, and their plain PyTorch
versions.

The forward kernel (``csrc/gat_attention.cu``) replaces the TPU kernel
``gsc_tpu/ops/pallas_gat.py::_gat_kernel``, which is dtype-polymorphic;
the source's ``gat_attention_f32`` and ``gat_attention_bf16`` entry points
are its f32 and bf16 forms.  The backward kernel
(``csrc/gat_attention_backward.cu``, entry points
``gat_attention_backward_f32`` and ``_bf16``) computes the same gradient
as the dense VJP that the JAX package's custom VJP takes
(``_gatv2_pallas_bwd``), without building its [B, N, N, F]
intermediates.  A graph of more than 32 nodes is cut into tiles of 32
target rows, one CTA each; in the backward a graph's tiles form one
thread block cluster (at most 8 CTAs, so N <= 256).  Each source's
header says what bounds it on the card and how its design answers that.
Each is compiled with ``nvcc`` for
``sm_90a`` from the repository's source at first use, into
``gsc_tpu_torch/_build/`` (one shared library per source digest, shared
by the wrappers of both dtypes), and bound with ``ctypes`` through a plain
C interface.

``attention_op(dtype)`` gives the forward wrapper of a dtype:
``gat_attention`` (f32) or ``gat_attention_bf16``; ``backward_op(dtype)``
the backward's (``gat_attention_backward``, ``gat_attention_backward_bf16``).
A wrapper dispatches on where the tensors lie: CUDA tensors launch its
kernel (or raise on what it does not take, another dtype included) through
a ``torch.autograd.Function`` whose backward launches the backward kernel
of the same dtype; CPU tensors run ``attention_plain``, which autograd
differentiates itself (the mirror of the JAX package's dense VJP).
``attention_backward_plain`` is the backward kernels' plain version: the
closed-form gradient, written without autograd.  There is no fallback from
a kernel to its plain version.  Each wrapper counts its kernel's launches
in ``launches``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .build import MAX_SMEM_BYTES, PKG, build_library
from .cost import (attention_backward_parts, attention_parts, posted,
                   watch_plain_backward)
from .gat import (LEAKY_SLOPE, LEAKY_SLOPE_BF16, NEG_INF, attention_dense,
                  bf16_pairwise)

SOURCE = PKG / "csrc" / "gat_attention.cu"
BACKWARD_SOURCE = PKG / "csrc" / "gat_attention_backward.cu"


# the forward kernel's plain PyTorch version: the dense masked attention
attention_plain = attention_dense


def attention_backward_plain(grad_out: torch.Tensor, xl: torch.Tensor,
                             xr: torch.Tensor, att: torch.Tensor,
                             adj: torch.Tensor, mean_aggr: bool):
    """The gradient of ``attention_plain`` in closed form (no autograd):
    ``(d_xl, d_xr, d_att, d_bias)`` for ``grad_out`` [..., N, F].

    Per graph and target row i, with alpha the forward's attention weights,
    d_i = max(deg_i, 1) under mean aggregation (1 under sum) and
    e_ijf = xl_jf + xr_if: g_i is taken as 0 on a row without a neighbour;
    dalpha_ij = (g_i . xl_j) / d_i; dl_ij = alpha_ij (dalpha_ij -
    sum_k alpha_ik dalpha_ik); d_att = sum dl_ij LeakyReLU(e_ij);
    d_xr_i = sum_j dl_ij att LeakyReLU'(e_ij); d_xl_j = sum_i alpha_ij g_i /
    d_i + dl_ij att LeakyReLU'(e_ij); d_bias = sum_i g_i.  LeakyReLU'(0) =
    1, as ``torch.where(e >= 0, ...)`` and ``jnp.where`` take it.

    dl is taken relative to the row's largest weight, at p = argmax_j
    alpha_ij: with delta_ij = dalpha_ij - dalpha_ip, dl_ij = alpha_ij
    (delta_ij - sum_k alpha_ik delta_ik), the same value since the weights
    sum to 1.  A saturated softmax (alpha_ip = 1 to f32 precision, as
    trained weights give with logits of several hundred) makes dalpha_ip -
    sum_k alpha_ik dalpha_ik a difference of two nearly equal numbers whose
    rounding would swamp dl; the pivot's own term is exactly 0 here, as
    autograd's gradient through the row max cancels it in the dense
    VJP.

    bf16 ``grad_out``/``xl``/``xr`` take the bf16 form
    (``attention_backward_wide``): f32 inside, d_xl and d_xr rounded once
    to bf16, d_att and d_bias f32."""
    if xl.dtype == torch.bfloat16:
        d_xl, d_xr, d_att, d_bias = attention_backward_wide(
            grad_out, xl, xr, att, adj, mean_aggr, torch.float32)
        return (d_xl.to(torch.bfloat16), d_xr.to(torch.bfloat16), d_att,
                d_bias)
    zero = torch.zeros((), dtype=xl.dtype, device=xl.device)
    e = xl[..., None, :, :] + xr[..., :, None, :]          # [..., i, j, F]
    pos = e >= 0
    act = torch.where(pos, e, LEAKY_SLOPE * e)
    slope = torch.where(pos, torch.ones((), dtype=xl.dtype, device=xl.device),
                        torch.full((), LEAKY_SLOPE, dtype=xl.dtype,
                                   device=xl.device))
    logits = torch.einsum("...ijf,f->...ij", act, att)
    logits = torch.where(adj, logits, torch.full((), NEG_INF,
                                                 device=xl.device))
    mx = logits.amax(dim=-1, keepdim=True)
    ex = torch.where(adj, torch.exp(logits - mx), zero)
    alpha = ex / ex.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    deg = adj.sum(dim=-1, keepdim=True)
    g = torch.where(deg > 0, grad_out, zero)
    d_bias = g.reshape(-1, g.shape[-1]).sum(dim=0)
    g_out = g / deg.clamp(min=1) if mean_aggr else g
    dalpha = torch.einsum("...if,...jf->...ij", g_out, xl)
    pivot = alpha.argmax(dim=-1, keepdim=True)
    delta = dalpha - torch.gather(dalpha, -1, pivot)
    dl = alpha * (delta - (alpha * delta).sum(dim=-1, keepdim=True))
    d_att = (dl[..., None] * act).reshape(-1, act.shape[-1]).sum(dim=0)
    de = dl[..., None] * att * slope                        # [..., i, j, F]
    d_xr = de.sum(dim=-2)
    d_xl = torch.einsum("...ij,...if->...jf", alpha, g_out) + de.sum(dim=-3)
    return d_xl, d_xr, d_att, d_bias


def attention_backward_wide(grad_out: torch.Tensor, xl: torch.Tensor,
                            xr: torch.Tensor, att: torch.Tensor,
                            adj: torch.Tensor, mean_aggr: bool,
                            wide: torch.dtype = torch.float64):
    """The gradient of the bf16 forward (``gat.attention_bf16``) on bf16
    ``grad_out``/``xl``/``xr``, computed in ``wide`` and returned there,
    unrounded: float32 is the bf16 backward kernel's plain version (before
    its one rounding of d_xl and d_xr), float64 the yardstick that the
    kernel, this plain version and the JAX package's VJP are held to.

    It is ``attention_backward_plain``'s closed form at the forward's own
    rounding points, each rounding's derivative taken as 1 (as autodiff
    does): the bf16 activations ``act`` of ``bf16_pairwise`` in the logits
    and in d_att, LeakyReLU' = 1 or ``LEAKY_SLOPE_BF16``, bf16(att) in the
    logits and in de, the unrounded weights alpha in dl (taken relative to
    the row's largest weight), and bf16(alpha), the weights the forward
    sums with, in d_xl's aggregation term.  Unlike the JAX package's bf16
    VJP, which rounds dalpha, de and d_att to bf16 on the way, nothing is
    rounded inside."""
    bf = torch.bfloat16
    zero = torch.zeros((), dtype=wide, device=xl.device)
    act_h, pos = bf16_pairwise(xl, xr)
    act = act_h.to(wide)
    slope = torch.where(pos, torch.ones((), dtype=wide, device=xl.device),
                        torch.full((), LEAKY_SLOPE_BF16, dtype=wide,
                                   device=xl.device))
    att_c = att.to(bf).to(wide)
    xlw = xl.to(wide)
    logits = torch.einsum("...ijf,f->...ij", act, att_c)
    logits = torch.where(adj, logits, torch.full((), NEG_INF, dtype=wide,
                                                 device=xl.device))
    mx = logits.amax(dim=-1, keepdim=True)
    ex = torch.where(adj, torch.exp(logits - mx), zero)
    alpha = ex / ex.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    deg = adj.sum(dim=-1, keepdim=True)
    g = torch.where(deg > 0, grad_out.to(wide), zero)
    d_bias = g.reshape(-1, g.shape[-1]).sum(dim=0)
    g_out = g / deg.clamp(min=1) if mean_aggr else g
    dalpha = torch.einsum("...if,...jf->...ij", g_out, xlw)
    pivot = alpha.argmax(dim=-1, keepdim=True)
    delta = dalpha - torch.gather(dalpha, -1, pivot)
    dl = alpha * (delta - (alpha * delta).sum(dim=-1, keepdim=True))
    d_att = (dl[..., None] * act).reshape(-1, act.shape[-1]).sum(dim=0)
    de = dl[..., None] * att_c * slope                      # [..., i, j, F]
    d_xr = de.sum(dim=-2)
    d_xl = torch.einsum("...ij,...if->...jf", alpha.to(bf).to(wide),
                        g_out) + de.sum(dim=-3)
    return d_xl, d_xr, d_att, d_bias


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as a pointer, through the
    binding PyTorch's generated kernels launch with: no
    ``torch.cuda.Stream`` object is built per launch."""
    return torch._C._cuda_getCurrentRawStream(index)


def _batch(lead) -> int:
    b = 1
    for d in lead:
        b *= d
    return b


# the loaded libraries by (source, flags), shared by the wrappers of both
# dtypes: one build and one load per source digest and process
_LIBS = {}
_LIBS_LOCK = threading.Lock()
# serving workers and a trainer launch from threads of their own: every
# wrapper's count goes up under this lock
_COUNT_LOCK = threading.Lock()
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _shared_library(source, flags, bind):
    """Build and load ``source`` once per process (the build itself once
    per digest, ``ops.build``); returns (library, build log of a fresh
    build or "")."""
    key = (str(source), tuple(flags))
    with _LIBS_LOCK:
        entry = _LIBS.setdefault(key, [threading.Lock(), None])
    with entry[0]:
        if entry[1] is not None:
            return entry[1], ""
        lib, log = build_library(source, flags)
        bind(lib)
        entry[1] = lib
        return lib, log


class _Kernel:
    """A kernel library built from ``source`` and loaded once, launched in
    one input dtype (``dtype``: float32 or bfloat16); launch counts in
    ``launches``.  ``stage_clocks=True`` builds it with
    ``-DGAT_STAGE_CLOCKS``: block 0 then records its stage clocks, which
    ``read_stage_clocks`` returns after a launch."""

    name = ""

    def __init__(self, source, stage_clocks: bool = False,
                 dtype: torch.dtype = torch.float32):
        if dtype not in _DTYPES:
            raise TypeError(f"{self.name}: no kernel for {dtype}")
        self.source = source
        self.flags = ("-DGAT_STAGE_CLOCKS",) if stage_clocks else ()
        self.dtype = dtype
        self.entry = f"{self.name}_{_DTYPES[dtype]}"
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        self._smem = {}

    def library(self) -> ctypes.CDLL:
        """Build (once per source digest) and load the shared library."""
        lib = self._lib
        if lib is None:
            with self._lock:
                if self._lib is None:
                    lib, log = _shared_library(self.source, self.flags,
                                               self._bind)
                    self.build_log = log
                    self._lib = lib
                lib = self._lib
        return lib

    def _bind(self, lib: ctypes.CDLL):
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        if self.flags:
            clocks = getattr(lib, f"{self.name}_stage_clocks")
            clocks.argtypes = [ctypes.c_void_p]
            clocks.restype = ctypes.c_int

    def read_stage_clocks(self):
        """Block 0's clock64() at each stage slot of the last launch (a
        stage-clocks build; synchronises the card)."""
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 8)()
        read = getattr(self.library(), f"{self.name}_stage_clocks")
        code = read(ctypes.addressof(buf))
        if code != 0:
            raise RuntimeError(f"{self.name}: reading stage clocks failed "
                               f"({code})")
        return list(buf)

    def _check(self, xl, tensors, features, masters, n, f):
        """Device and contiguity of every tensor, the dtypes (``features``
        in the wrapper's dtype, the ``masters`` att and bias in f32) and
        the shared memory that (n, f) needs; returns the library."""
        dev = xl.device
        if dev.type != "cuda":
            raise ValueError(f"{self.entry}: the kernel takes CUDA tensors, "
                             f"got {dev}")
        for t in tensors:
            if t.device != dev:
                raise ValueError(f"{self.entry}: tensors on {t.device} and "
                                 f"{dev}; the kernel takes CUDA tensors on "
                                 "one device")
            if not t.is_contiguous():
                raise ValueError(f"{self.entry}: a {tuple(t.shape)} input is "
                                 "not contiguous")
        for t in features:
            if t.dtype != self.dtype:
                raise TypeError(f"{self.entry}: a feature input is {t.dtype}, "
                                f"the kernel takes {self.dtype}")
        for t in masters:
            if t.dtype != torch.float32:
                raise TypeError(f"{self.entry}: att or bias is {t.dtype}, the "
                                "kernel takes f32")
        if n < 1 or f < 1:
            raise ValueError(f"{self.entry}: empty graph shape N={n} F={f}")
        lib = self.library()
        smem = self._smem.get((n, f))
        if smem is None:
            smem = self._smem[(n, f)] = int(self._smem_bytes(lib, n, f))
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"{self.entry}: N={n}, F={f} needs {smem} bytes of shared "
                f"memory, more than a block's {MAX_SMEM_BYTES}")
        return lib

    def _smem_bytes(self, lib, n, f):
        return getattr(lib, f"{self.name}_smem_bytes")(
            n, f, int(self.dtype == torch.bfloat16))

    def _run(self, lib, dev, stream, *args):
        """Call the C launch function on ``stream`` of ``dev`` and raise on
        its error code.  No device context is entered when ``dev`` is the
        current device."""
        fn = getattr(lib, self.entry)
        if dev.index == torch.cuda.current_device():
            code = fn(*args, stream)
        else:
            with torch.cuda.device(dev):
                code = fn(*args, stream)
        if code != 0:
            raise RuntimeError(
                f"{self.entry} kernel launch failed: "
                f"{getattr(lib, self.name + '_error_string')(code).decode()}"
                f" ({code})")
        with _COUNT_LOCK:
            self.launches += 1


class _GatAttentionFn(torch.autograd.Function):
    """The forward kernel with a gradient: the backward launches the
    backward kernel of the same dtype.  Neither the dense VJP nor any
    other plain code runs on the card in its place."""

    @staticmethod
    def forward(ctx, op, xl, xr, att, bias, adj, mean_aggr):
        ctx.save_for_backward(xl, xr, att, adj)
        ctx.mean_aggr = mean_aggr
        return op.launch(xl, xr, att, bias, adj, mean_aggr)

    @staticmethod
    def backward(ctx, grad_out):
        xl, xr, att, adj = ctx.saved_tensors
        grads = backward_op(xl.dtype).launch(grad_out.contiguous(), xl, xr,
                                             att, adj, ctx.mean_aggr)
        return (None, *grads, None, None)


class GatAttention(_Kernel):
    """Callable wrapper around the forward kernel of one dtype: builds and
    loads the library on first CUDA use, validates arguments, launches on
    the current stream and counts launches in ``launches``."""

    name = "gat_attention"

    def __init__(self, source=SOURCE, stage_clocks: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(source, stage_clocks, dtype)

    def _bind(self, lib):
        super()._bind(lib)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for entry in ("gat_attention_f32", "gat_attention_bf16"):
            fn = getattr(lib, entry)
            fn.argtypes = [vp] * 6 + [ci] * 4 + [vp]
            fn.restype = ci
        lib.gat_attention_smem_bytes.argtypes = [ci, ci, ci]
        lib.gat_attention_smem_bytes.restype = ctypes.c_longlong

    def __call__(self, xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor,
                 bias: torch.Tensor, adj: torch.Tensor,
                 mean_aggr: bool = True) -> torch.Tensor:
        """xl, xr [..., N, F] of the wrapper's dtype; att, bias [F] f32;
        adj [..., N, N] bool."""
        if xl.device.type == "cpu":
            with posted("gat_attention", attention_parts, xl, xr, att, bias,
                        adj) as t:
                out = attention_plain(xl, xr, att, bias, adj, mean_aggr)
            watch_plain_backward(t, out, (xl, xr, att, bias),
                                 "gat_attention_backward",
                                 attention_backward_parts, out, xl, xr, att,
                                 adj)
            return out
        return _GatAttentionFn.apply(self, xl, xr, att, bias, adj,
                                     bool(mean_aggr))

    def launch(self, xl, xr, att, bias, adj, mean_aggr: bool = True
               ) -> torch.Tensor:
        """Run the kernel on CUDA tensors; raises on anything it does not
        take."""
        n, f = xl.shape[-2], xl.shape[-1]
        lead = xl.shape[:-2]
        if xr.shape != xl.shape or att.shape != (f,) or bias.shape != (f,) \
                or adj.shape != lead + (n, n):
            raise ValueError(
                f"{self.entry}: shapes xl {tuple(xl.shape)}, xr "
                f"{tuple(xr.shape)}, att {tuple(att.shape)}, bias "
                f"{tuple(bias.shape)}, adj {tuple(adj.shape)} do not match")
        if adj.dtype != torch.bool:
            raise TypeError(f"{self.entry}: adj is {adj.dtype}, want bool")
        lib = self._check(xl, (xr, att, bias, adj), (xl, xr), (att, bias),
                          n, f)
        with posted("gat_attention", attention_parts, xl, xr, att, bias,
                    adj):
            out = torch.empty_like(xl)
            self._run(lib, xl.device, _raw_stream(xl.device.index),
                      xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                      bias.data_ptr(), adj.data_ptr(), out.data_ptr(),
                      _batch(lead), n, f, int(bool(mean_aggr)))
        return out


class GatAttentionBackward(_Kernel):
    """Callable wrapper around the backward kernel of one dtype: ``(d_xl,
    d_xr, d_att, d_bias)`` of the attention stage for ``grad_out``, d_xl
    and d_xr in the wrapper's dtype, d_att and d_bias f32.  CPU tensors
    run ``attention_backward_plain``; CUDA tensors launch the kernel once
    and nothing else.

    A graph of up to 32 nodes is one CTA, a larger one (up to 256) a
    cluster of one CTA per 32 target rows.  The kernel recomputes the
    forward's weights bit for bit, takes dl relative to each row's largest
    weight, and sums each triple's d_xr, d_xl and d_att terms in register
    tiles; a cluster's CTAs add their d_xl column sums in rank order
    through distributed shared memory.  Each graph's ``d_att``/``d_bias``
    terms go to a scratch buffer of [B, 2 F] doubles, and the last graph
    to finish adds them in graph order, so two launches give the same bits
    (no float atomics).  The count of finished graphs that finds the last
    one lives in device memory, one per device and stream, since launches
    on one stream run one at a time; the last graph resets it."""

    name = "gat_attention_backward"

    def __init__(self, source=BACKWARD_SOURCE, stage_clocks: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(source, stage_clocks, dtype)
        self._counters = {}

    def _bind(self, lib):
        super()._bind(lib)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for entry in ("gat_attention_backward_f32",
                      "gat_attention_backward_bf16"):
            fn = getattr(lib, entry)
            fn.argtypes = [vp] * 11 + [ci] * 4 + [vp]
            fn.restype = ci
        lib.gat_attention_backward_smem_bytes.argtypes = [ci, ci, ci]
        lib.gat_attention_backward_smem_bytes.restype = ctypes.c_longlong
        lib.gat_attention_backward_tiles.argtypes = [ci]
        lib.gat_attention_backward_tiles.restype = ci

    def __call__(self, grad_out, xl, xr, att, adj, mean_aggr: bool = True):
        if xl.device.type == "cpu":
            with posted("gat_attention_backward", attention_backward_parts,
                        grad_out, xl, xr, att, adj):
                return attention_backward_plain(grad_out, xl, xr, att, adj,
                                                mean_aggr)
        return self.launch(grad_out, xl, xr, att, adj, mean_aggr)

    def launch(self, grad_out, xl, xr, att, adj, mean_aggr: bool = True):
        """Run the kernel on CUDA tensors; raises on anything it does not
        take."""
        n, f = xl.shape[-2], xl.shape[-1]
        lead = xl.shape[:-2]
        if grad_out.shape != xl.shape or xr.shape != xl.shape \
                or att.shape != (f,) or adj.shape != lead + (n, n):
            raise ValueError(
                f"{self.entry}: shapes grad_out "
                f"{tuple(grad_out.shape)}, xl {tuple(xl.shape)}, xr "
                f"{tuple(xr.shape)}, att {tuple(att.shape)}, adj "
                f"{tuple(adj.shape)} do not match")
        if adj.dtype != torch.bool:
            raise TypeError(f"{self.entry}: adj is {adj.dtype}, want bool")
        lib = self._check(xl, (grad_out, xr, att, adj), (grad_out, xl, xr),
                          (att,), n, f)
        if lib.gat_attention_backward_tiles(n) < 1:
            raise ValueError(f"{self.entry}: N={n} needs more CTAs per graph "
                             "than one cluster holds")
        with posted("gat_attention_backward", attention_backward_parts,
                    grad_out, xl, xr, att, adj):
            return self._launch(lib, grad_out, xl, xr, att, adj, lead, n, f,
                                mean_aggr)

    def _launch(self, lib, grad_out, xl, xr, att, adj, lead, n, f,
                mean_aggr):
        b = _batch(lead)
        d_xl = torch.empty_like(xl)
        d_xr = torch.empty_like(xl)
        # d_att, d_bias (f32), then each graph's terms of both in double
        # (8-byte aligned at 8 f bytes); an empty batch launches nothing
        alloc = torch.empty if b else torch.zeros
        small = alloc(2 * f + 4 * f * b, dtype=torch.float32,
                      device=xl.device)
        stream = _raw_stream(xl.device.index)
        counter = self._counters.get((xl.device.index, stream))
        if counter is None:
            # the kernel's last block resets it to 0 for the next launch
            counter = self._counters[(xl.device.index, stream)] = \
                torch.zeros(1, dtype=torch.int32, device=xl.device)
        self._run(lib, xl.device, stream, grad_out.data_ptr(),
                  xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                  adj.data_ptr(), d_xl.data_ptr(), d_xr.data_ptr(),
                  small.data_ptr(), small.data_ptr() + 4 * f,
                  small.data_ptr() + 8 * f, counter.data_ptr(), b, n, f,
                  int(bool(mean_aggr)))
        return d_xl, d_xr, small[:f], small[f:2 * f]


gat_attention = GatAttention()
gat_attention_bf16 = GatAttention(dtype=torch.bfloat16)
gat_attention_backward = GatAttentionBackward()
gat_attention_backward_bf16 = GatAttentionBackward(dtype=torch.bfloat16)
_FORWARD = {torch.float32: gat_attention, torch.bfloat16: gat_attention_bf16}
_BACKWARD = {torch.float32: gat_attention_backward,
             torch.bfloat16: gat_attention_backward_bf16}


def attention_op(dtype: torch.dtype) -> GatAttention:
    """The forward wrapper for features of ``dtype``: the bf16 kernel's for
    bfloat16, else the f32 kernel's (which raises on a CUDA tensor of any
    other dtype; CPU tensors of any dtype run the plain version)."""
    return _FORWARD.get(dtype, gat_attention)


def backward_op(dtype: torch.dtype) -> GatAttentionBackward:
    """The backward wrapper for features of ``dtype`` (as ``attention_op``)."""
    return _BACKWARD.get(dtype, gat_attention_backward)

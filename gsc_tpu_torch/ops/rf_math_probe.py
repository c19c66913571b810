"""The probe of ``csrc/rf_math.cuh`` on the card, a check only:
``csrc/rf_math_probe.cu`` evaluates the header's functions on a vector
of loads, so they can be held bit for bit against their plain version,
``rf_math.plain_values``.  Kernel #2's plugin build compiles the same
header; nothing on the main path calls this module.  The library is
built on first use, never at import.
"""
from __future__ import annotations

import ctypes

from .build import PKG, build_library
from .rf_math import PROBE_ORDER

_PROBE = {}


def probe_library():
    """(the probe's library, the compiler's log of a fresh build): built
    once per process from ``csrc/rf_math_probe.cu``."""
    if "lib" not in _PROBE:
        lib, log = build_library(PKG / "csrc" / "rf_math_probe.cu",
                                 ("-fmad=false",))
        lib.rf_math_probe.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_void_p]
        lib.rf_math_probe.restype = ctypes.c_int
        if lib.rf_math_probe_outputs() != len(PROBE_ORDER):
            raise RuntimeError("the probe's outputs differ from "
                               "PROBE_ORDER")
        _PROBE.update(lib=lib, log=log)
    return _PROBE["lib"], _PROBE["log"]


def card_values(x, y):
    """The header's functions evaluated on the card by the probe kernel
    (``csrc/rf_math_probe.cu``, built on first use): [n,
    len(PROBE_ORDER)] f32 on the device of ``x`` and ``y``, 1-d f32 CUDA
    tensors.  A check only: kernel #2's plugin build compiles the same
    header."""
    import torch

    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError("card_values takes two CUDA tensors on one device")
    lib, _ = probe_library()
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    out = torch.empty(x.numel(), len(PROBE_ORDER), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = lib.rf_math_probe(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                 x.numel(), stream)
    if code != 0:
        raise RuntimeError(f"rf_math_probe launch failed ({code})")
    return out

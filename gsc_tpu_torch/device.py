"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the card (``"cuda"``).
Without CUDA they raise unless the caller asked for ``"cpu"`` itself:
nothing moves to the CPU quietly.  ``upload`` puts a host table on a
device without synchronising the host with the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        # The JAX reference runs its matmuls at "highest" precision, so the
        # port keeps TF32 off for matmuls and cuDNN alike: f32 stays f32.
        # A bf16 GEMM, should one run, reduces in f32 as the JAX package's
        # preferred_element_type=float32 contractions do.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(data, dtype: torch.dtype, device) -> torch.Tensor:
    """Host data (a numpy array or a list) as a ``dtype`` tensor on
    ``device``.  To the card it goes through pinned memory in a
    non-blocking copy: a copy from pageable memory makes the host wait
    for the card (a synchronizing operation), this one does not, and the
    caching host allocator keeps the pinned block until the copy has
    run."""
    t = torch.as_tensor(data, dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)

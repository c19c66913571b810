"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the card (``"cuda"``).
Without CUDA they raise unless the caller asked for ``"cpu"`` itself:
nothing moves to the CPU quietly.
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
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

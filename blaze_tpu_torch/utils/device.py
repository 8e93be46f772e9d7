"""Device choice for the PyTorch port.

``resolve_device(None)`` is the card: the port never continues on the CPU
unless the caller names it. The CPU path exists for the tests, which run
every kernel's plain PyTorch version against the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` -> the current CUDA device (raises when no GPU is visible);
    ``"cpu"`` -> the CPU; a CUDA device string must name a visible GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "blaze_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"device type {dev.type!r} is not supported")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:  # tensors report their index: cuda -> cuda:N
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for another device:
`device=None` means CUDA, and a missing GPU is an error, never a quiet
detour to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "piquant_tpu_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:   # "cuda" -> "cuda:<current>", as tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

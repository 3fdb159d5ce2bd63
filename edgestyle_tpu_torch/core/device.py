"""Device and generator helpers for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
GPU and no ``device="cpu"`` they raise rather than carry on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def make_generator(seed: int, device: DeviceLike = "cuda") -> torch.Generator:
    """An explicit generator on ``device``, seeded."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' (PipelineConfig.dtype) -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]

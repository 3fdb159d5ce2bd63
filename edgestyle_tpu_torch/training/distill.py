"""The serving side of LCM-LoRA distillation.

Counterpart of edgestyle_tpu/training/distill.py's :func:`apply_lcm_lora`:
the distilled adapters merged into the UNet's kernels, for few-step
sampling with ``PipelineConfig(scheduler="lcm")``. The distiller itself is
not ported yet (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

from typing import Dict

from edgestyle_tpu_torch.models.unet import merge_lora


def apply_lcm_lora(unet_params: Dict, lcm_lora: Dict, scale: float = 1.0) -> Dict:
    """UNet params with the adapters ({path: {'down', 'up'}}, the port's
    layout, as ``training/checkpoint.py::import_safetensors`` gives them)
    merged: kernel <- kernel + scale * (up o down), as a new tree."""
    return merge_lora(unet_params, lcm_lora, scale)

"""Validation by generation (the reference's log_validation,
train_text2image_pretrained_openpose.py:66-219): every N steps, run the
try-on pipeline with the current trainable weights at several guidance
scales and log the ground truth, the conditioning and the generations as
one image grid.

Counterpart of edgestyle_tpu/training/validation.py. The batch is one
micro-batch as the port's trainer holds it (NCHW tensors, the VAE-facing
images in [-1, 1], the poses in [0, 1]); the grid is HWC numpy in [0, 1].
Every guidance scale starts from a generator seeded alike, as the JAX
package passes every scale the same key.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.models.unet import controllora_params

# the reference sweeps guidance = linspace(3.0, 7.5, num_validation_images)
# (train...py:146,152); 4 images by default
VALIDATION_GUIDANCE_SCALES = (3.0, 4.5, 6.0, 7.5)


def assemble_inference_params(frozen: Dict, trainable: Dict) -> Dict:
    """frozen {vae, clip, unet, static} + trainable {lora_*, heads_*,
    fusion} -> the pipeline's params (each LoRA merged into its tied trunk)."""
    return {
        "vae": frozen["vae"],
        "clip": frozen["clip"],
        "unet": frozen["unet"],
        "controlnet": {
            "static": frozen["static"],
            "lora_0": controllora_params(frozen["unet"], trainable["lora_0"], trainable["heads_0"]),
            "lora_1": controllora_params(frozen["unet"], trainable["lora_1"], trainable["heads_1"]),
            "fusion": trainable["fusion"],
        },
    }


def _row(images: torch.Tensor) -> np.ndarray:
    """(B, 3, H, W) -> one HWC row of the B images side by side."""
    hwc = images.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    return np.concatenate(list(hwc), axis=1)


@torch.no_grad()
def log_validation(pipe, frozen: Dict, trainable: Dict, batch: Dict[str, torch.Tensor],
                   step: int, writer=None,
                   guidance_scales: Sequence[float] = VALIDATION_GUIDANCE_SCALES,
                   num_inference_steps: int = 20, seed: int = 0,
                   use_agnostic: bool = False) -> np.ndarray:
    """The grid (H * (3 + len(guidance_scales)), W * B, 3) float32 in
    [0, 1]: the ground truth, branch 0's image (agnostic or head, as the
    trainer's ``--use_agnostic_images`` picks, reference train...py:109-112),
    the original pose, then one row of generations per guidance scale
    (negative ids all zeros). Logged to ``writer`` when given."""
    params = assemble_inference_params(frozen, trainable)
    first = batch["agnostic"] if use_agnostic else batch["head"]
    cond = [first, batch["original_openpose"], batch["clothes"], batch["clothes_openpose"],
            batch["clothes2"], batch["clothes_openpose2"]]
    ids = batch["input_ids"]
    neg = torch.zeros_like(ids)

    rows = [_row((batch["original"] / 2 + 0.5).clamp(0, 1)), _row((first / 2 + 0.5).clamp(0, 1)),
            _row(batch["original_openpose"].clamp(0, 1))]
    for g in guidance_scales:
        out = pipe(params, ids, neg, cond, generator=make_generator(seed, pipe.device),
                   num_inference_steps=num_inference_steps, guidance_scale=float(g))
        rows.append(_row(out))
    grid = np.concatenate(rows, axis=0)
    if writer is not None:
        writer.add_image("validation", grid, step, dataformats="HWC")
    return grid

"""CollateFn: per-example dicts of HWC uint8 images → fixed-shape float32
NHWC batch (the reference's model/utils.py:891-1019); a copy of
edgestyle_tpu/data/collate.py. The trainer moves the batch to the card as
NCHW (apps/train.py).

Field dtype split follows the reference exactly: VAE-facing images are
normalized to [-1,1] (IMAGES_TRANSFORMS) when `uses_vae` (the ControlLoRA
VAE-conditioning mode the trainer runs with), conditioning/pose images stay
[0,1]. The paired zoom/shift transform couples (target, clothes, pose)
triplets. Output keys match training.train_step.BATCH_KEYS plus
head/target/target2."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from edgestyle_tpu_torch.data.augment import Augmentations
from edgestyle_tpu_torch.data.transforms import (
    BG_COLOR,
    BG_COLOR_CONTROLNET,
    make_inpaint_condition,
    paired_transform,
    standard_image,
    to_float01,
    to_norm,
)


class CollateFn:
    def __init__(
        self,
        empty_prompt: np.ndarray,
        proportion_empty_prompts: float = 0.0,
        proportion_empty_images: float = 0.0,
        proportion_patchworked_images: float = 0.0,
        proportion_cutout_images: float = 0.0,
        proportion_patchworks: float = 0.0,
        uses_vae: bool = True,
        use_inpaint: bool = False,
    ):
        self.aug = Augmentations(
            empty_prompt,
            proportion_empty_prompts,
            proportion_empty_images,
            proportion_patchworked_images,
            proportion_cutout_images,
            proportion_patchworks,
        )
        self.uses_vae = uses_vae
        self.use_inpaint = use_inpaint

    def __call__(self, examples: List[Dict], rng: np.random.Generator) -> Dict[str, np.ndarray]:
        examples = [dict(ex) for ex in examples]
        examples = self.aug(examples, rng)

        colors = [BG_COLOR, BG_COLOR, BG_COLOR_CONTROLNET]
        for ex in examples:
            t, c, o = paired_transform(
                [ex["target"], ex["clothes"], ex["clothes_openpose"]], colors, rng
            )
            ex["target"], ex["clothes"], ex["clothes_openpose"] = t, c, o
            t2, c2, o2 = paired_transform(
                [ex["target2"], ex["clothes2"], ex["clothes_openpose2"]], colors, rng
            )
            ex["target2"], ex["clothes2"], ex["clothes_openpose2"] = t2, c2, o2

        vae_t = to_norm if self.uses_vae else to_float01
        field_transforms = {
            "original": to_norm,
            "agnostic": vae_t,
            "head": vae_t,
            "original_openpose": to_float01,
            "clothes": vae_t,
            "clothes_openpose": to_float01,
            "target": to_norm,
            "clothes2": vae_t,
            "clothes_openpose2": to_float01,
            "target2": to_norm,
        }
        batch = {
            f: np.stack([t(standard_image(ex[f])) for ex in examples]).astype(np.float32)
            for f, t in field_transforms.items()
        }
        batch["input_ids"] = np.stack(
            [np.asarray(ex["input_ids"], np.int32) for ex in examples]
        )
        if self.use_inpaint:
            batch["agnostic"] = make_inpaint_condition(batch["agnostic"])
            batch["head"] = make_inpaint_condition(batch["head"])
        return batch


def shard_for_accum(batch: Dict[str, np.ndarray], grad_accum: int) -> Dict[str, np.ndarray]:
    """(B, ...) → (grad_accum, B/grad_accum, ...) for the scan-based
    accumulation in training.train_step."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
        out[k] = v.reshape(grad_accum, b // grad_accum, *v.shape[1:])
    return out

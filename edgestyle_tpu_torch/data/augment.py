"""Stochastic training augmentations, a copy of
edgestyle_tpu/data/augment.py (the reference's Augmentations,
model/utils.py:713-888): empty-prompt, empty-image,
patchwork, and cutout-half-along-a-random-line-through-the-pose-center.
The reference's per-pixel Python loop in remove_half_image becomes one
vectorized meshgrid mask."""

from __future__ import annotations

import math
import numpy as np

from edgestyle_tpu_torch.data.transforms import (
    BG_COLOR,
    RESOLUTION,
    RESOLUTION_PATCH,
    patched_transform,
)


def find_center(openpose_img: np.ndarray) -> tuple:
    """(x, y) center of non-zero pixels (reference find_center :808-837)."""
    nz = np.any(openpose_img != 0, axis=-1) if openpose_img.ndim == 3 else openpose_img != 0
    idx = np.argwhere(nz)
    if idx.size == 0:
        return (openpose_img.shape[1] / 2, openpose_img.shape[0] / 2)
    cy, cx = idx.mean(axis=0)
    return (cx, cy)


def remove_half_image(
    img: np.ndarray, center_x: float, center_y: float, rng: np.random.Generator,
    color=BG_COLOR,
) -> np.ndarray:
    """Color one side of a random line through (cx, cy) (reference
    remove_half_image :838-888), vectorized."""
    h, w = img.shape[:2]
    angle = rng.uniform(0.0, 360.0)
    ys, xs = np.mgrid[0:h, 0:w]
    if angle not in (90.0, 270.0):
        m = math.tan(math.radians(angle))
        b = center_y - m * center_x
        above = ys > (m * xs + b)
        side = 0 > b  # is_above_line(0, 0)
    else:
        above = xs > center_x if angle == 90.0 else xs < center_x
        side = (0 > center_x) if angle == 90.0 else (0 < center_x)
    mask = above == side
    out = img.copy()
    out[mask] = np.asarray(color, img.dtype)
    return out


class Augmentations:
    """Mutates a list of per-example dicts of HWC uint8 images + input_ids.
    Proportions are cumulative thresholds exactly as in the reference
    (:723-735) — note they intentionally chain elifs on fresh draws."""

    def __init__(
        self,
        empty_prompt: np.ndarray,
        proportion_empty_prompts: float = 0.0,
        proportion_empty_images: float = 0.0,
        proportion_patchworked_images: float = 0.0,
        proportion_cutout_images: float = 0.0,
        proportion_patchworks: float = 0.0,
    ):
        p = [
            proportion_empty_prompts,
            proportion_empty_prompts + proportion_empty_images,
            proportion_empty_prompts + proportion_empty_images + proportion_patchworked_images,
            proportion_empty_prompts + proportion_empty_images
            + proportion_patchworked_images + proportion_cutout_images,
        ]
        self.proportions = p
        self.proportion_patchworks = proportion_patchworks
        self.empty_prompt = empty_prompt

    def __call__(self, examples, rng: np.random.Generator):
        bg = np.full((RESOLUTION, RESOLUTION, 3), BG_COLOR, np.uint8)
        for ex in examples:
            if rng.random() < self.proportions[0]:
                ex["input_ids"] = np.asarray(self.empty_prompt)
            elif rng.random() < self.proportions[1]:
                if rng.random() < 0.5:
                    ex["agnostic"] = bg.copy()
                    ex["head"] = bg.copy()
                elif rng.random() < 0.5:
                    ex["clothes"] = bg.copy()
                else:
                    ex["clothes2"] = bg.copy()
            elif rng.random() < self.proportions[2]:
                pt = lambda im: patched_transform(
                    im, rng, RESOLUTION_PATCH, self.proportion_patchworks, BG_COLOR
                )
                r = rng.random()
                if r < 0.3333:
                    ex["agnostic"] = pt(ex["agnostic"])
                    ex["head"] = pt(ex["head"])
                elif r < 0.6666:
                    ex["clothes"] = pt(ex["clothes"])
                else:
                    ex["clothes2"] = pt(ex["clothes2"])
            elif rng.random() < self.proportions[3]:
                r = rng.random()
                if r < 0.333:
                    cx, cy = find_center(ex["original_openpose"])
                    ex["agnostic"] = remove_half_image(ex["agnostic"], cx, cy, rng)
                    ex["head"] = remove_half_image(ex["head"], cx, cy, rng)
                elif r < 0.666:
                    cx, cy = find_center(ex["clothes_openpose"])
                    ex["clothes"] = remove_half_image(ex["clothes"], cx, cy, rng)
                else:
                    cx, cy = find_center(ex["clothes_openpose2"])
                    ex["clothes2"] = remove_half_image(ex["clothes2"], cx, cy, rng)
        return examples

"""Host-side image transforms (numpy, NHWC, seed-controlled).

A copy of edgestyle_tpu/data/transforms.py (framework-free host code; the
port imports nothing of the JAX package), the reference's
model/utils.py:14-180: the two tensorization
transforms (normalized [-1,1] for VAE-facing images vs raw [0,1] for
conditioning images), random gray-patch dropout (PatchedTransform), and the
paired zoom/shift/pad transform applied consistently across
(target, clothes, pose) triplets, including its 1-px black-border cleanup.

Everything is vectorized numpy driven by an explicit np.random.Generator:
the train step on the card only ever sees fixed-shape float32 batches, and
the same seed gives the JAX trainer's batches bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

RESOLUTION = 512
RESOLUTION_PATCH = (16, 32, 64)
BG_COLOR = (127, 127, 127)
BG_COLOR_CONTROLNET = (0, 0, 0)


def to_float01(img_u8: np.ndarray) -> np.ndarray:
    """HWC uint8 → float32 [0,1] (CONDITIONING_IMAGES_TRANSFORMS tail)."""
    return img_u8.astype(np.float32) / 255.0


def to_norm(img_u8: np.ndarray) -> np.ndarray:
    """HWC uint8 → float32 [-1,1] (IMAGES_TRANSFORMS tail)."""
    return img_u8.astype(np.float32) / 127.5 - 1.0


def resize_nearest(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize, HWC."""
    h, w = img.shape[:2]
    th, tw = size_hw
    ri = (np.arange(th) * (h / th)).astype(np.int64).clip(0, h - 1)
    ci = (np.arange(tw) * (w / tw)).astype(np.int64).clip(0, w - 1)
    return img[ri][:, ci]


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(size) semantics: shorter side → size."""
    h, w = img.shape[:2]
    if h <= w:
        return resize_nearest(img, (size, int(round(w * size / h))))
    return resize_nearest(img, (int(round(h * size / w)), size))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    out = img[top : top + size, left : left + size]
    if out.shape[0] != size or out.shape[1] != size:  # pad if smaller
        pad_h, pad_w = size - out.shape[0], size - out.shape[1]
        out = np.pad(
            out,
            ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2), (0, 0)),
        )
    return out


def standard_image(img_u8: np.ndarray, size: int = RESOLUTION) -> np.ndarray:
    """Resize(shorter→size, nearest) + center crop — the head of both
    reference transforms."""
    return center_crop(resize_shorter_side(img_u8, size), size)


def patched_transform(
    img_u8: np.ndarray,
    rng: np.random.Generator,
    patch_sizes: Sequence[int] = RESOLUTION_PATCH,
    color_percentage: float = 0.1,
    color: Tuple[int, int, int] = BG_COLOR,
) -> np.ndarray:
    """Random gray-patch dropout (reference PatchedTransform :38-67)."""
    out = img_u8.copy()
    h, w = out.shape[:2]
    ps = int(rng.choice(np.asarray(patch_sizes)))
    ph, pw = h // ps, w // ps
    total = ph * pw
    n = int(total * color_percentage)
    idx = rng.choice(total, size=n, replace=False)
    col = np.asarray(color, out.dtype)
    for i in idx:
        r, c = (i // pw) * ps, (i % pw) * ps
        out[r : r + ps, c : c + ps] = col
    return out


def _cleanup_border(img: np.ndarray, color: Tuple[int, int, int], border: int = 1):
    """Replace pure-black border pixels with the pad color (reference
    cleanup_border :75-93 — fixes the affine's black seam)."""
    col = np.asarray(color, img.dtype)
    for j in range(border):
        for sl in (np.s_[j, :], np.s_[-1 - j, :], np.s_[:, j], np.s_[:, -1 - j]):
            row = img[sl]
            black = (row == 0).all(axis=-1)
            row[black] = col
    return img


def _shift(img: np.ndarray, dx: int, dy: int, color) -> np.ndarray:
    out = np.empty_like(img)
    out[...] = np.asarray(color, img.dtype)
    h, w = img.shape[:2]
    src_y = slice(max(0, -dy), min(h, h - dy))
    dst_y = slice(max(0, dy), min(h, h + dy))
    src_x = slice(max(0, -dx), min(w, w - dx))
    dst_x = slice(max(0, dx), min(w, w + dx))
    out[dst_y, dst_x] = img[src_y, src_x]
    return out


def paired_transform(
    images: List[np.ndarray],
    padding_colors: List[Tuple[int, int, int]],
    rng: np.random.Generator,
    output_size: int = RESOLUTION,
) -> List[np.ndarray]:
    """Consistent random zoom (0.8–1.2) + shift (±50) across a triplet,
    per-image pad colors (reference PairedTransform :70-180)."""
    if len(images) != len(padding_colors):
        raise ValueError("images and padding colors must match")
    scale = rng.uniform(0.8, 1.2)
    new_size = int(output_size * scale)
    dx, dy = int(rng.integers(-50, 51)), int(rng.integers(-50, 51))
    if scale > 1.0:
        top = int(rng.integers(0, new_size - output_size + 1))
        left = int(rng.integers(0, new_size - output_size + 1))

    out = []
    for img, color in zip(images, padding_colors):
        r = resize_nearest(img, (new_size, new_size))
        if scale < 1.0:
            pad = (output_size - new_size) // 2
            pad2 = output_size - new_size - pad
            r = np.pad(
                r, ((pad, pad2), (pad, pad2), (0, 0)), constant_values=0
            )
            # constant pad with per-channel color:
            r[:pad, :] = color
            r[r.shape[0] - pad2 :, :] = color
            r[:, :pad] = color
            r[:, r.shape[1] - pad2 :] = color
        elif scale > 1.0:
            r = r[top : top + output_size, left : left + output_size]
        r = _shift(r, dx, dy, color)
        r = _cleanup_border(r, color)
        out.append(r)
    return out


def make_inpaint_condition(images: np.ndarray, eps: float = 0.1) -> np.ndarray:
    """Set gray-background pixels to -1 in [-1,1] images (reference
    make_inpaint_condition :988-1019)."""
    target = np.asarray(BG_COLOR, np.float32) / 255.0 * 2.0 - 1.0
    mask = np.all(np.abs(images - target) < eps, axis=-1, keepdims=True)
    return np.where(mask, -1.0, images)

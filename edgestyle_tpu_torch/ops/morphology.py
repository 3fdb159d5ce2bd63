"""Binary-mask morphology on batches of masks.

Counterpart of edgestyle_tpu/ops/morphology.py (the reference's cv2/skimage
mask post-processing as tensor ops). Every function takes a leading batch
axis: masks are (B, H, W) bool, images (B, 3, H, W), where the JAX app
vmaps its one-image functions over the batch.

  * dilate/erode        -- k x k max/min pool, stride 1, padded with -inf
                           for the max and +inf for the min (the min is
                           the max of the negated mask);
  * open/close/smooth   -- compositions of those;
  * largest component   -- per-pixel seed ids propagated by run sweeps to
                           their fixpoint, then the most frequent id;
  * bounding box        -- masked min/max over coordinate grids.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _max_pool(m: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W) float -> k x k max pool, stride 1, same size."""
    return F.max_pool2d(m[:, None], k, stride=1, padding=k // 2)[:, 0]


def dilate(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    m = mask.float()
    for _ in range(iterations):
        m = _max_pool(m, k)
    return m > 0.5


def erode(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    m = mask.float()
    for _ in range(iterations):
        m = -_max_pool(-m, k)
    return m > 0.5


def closing(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    return erode(dilate(mask, k, iterations), k, iterations)


def opening(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    return dilate(erode(mask, k, iterations), k, iterations)


def smooth_mask(mask: torch.Tensor, k: int = 3, iterations: int = 3) -> torch.Tensor:
    """closing then opening (reference smooth_mask, extract_dataset.py:338-352)."""
    return opening(closing(mask, k, iterations), k, iterations)


def _run_max(cur: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each mask pixel of (B, H, W) ``cur`` -> the max of ``cur`` over its
    run of consecutive mask pixels along the last axis; 0 off the mask.
    That is the JAX sweep's forward and backward segmented cumulative max
    taken together. Runs are numbered by a cumulative sum of their starts
    over the whole batch (a row's first pixel always starts a run), so one
    scatter-max gives every run's max."""
    prev = F.pad(mask[..., :-1], (1, 0), value=False)
    run = torch.cumsum((mask & ~prev).reshape(-1), 0).reshape(mask.shape)
    run = torch.where(mask, run, torch.zeros_like(run))
    best = torch.zeros(mask.numel() + 1, dtype=cur.dtype, device=cur.device)
    best = best.scatter_reduce(0, run.reshape(-1), cur.reshape(-1), "amax")
    return torch.where(mask, best[run], torch.zeros_like(cur))


def component_labels(mask: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(B, H, W) bool -> (labels, sweeps). Each pixel of a 4-connected
    component gets the largest seed id (flat index + 1) of its component,
    background 0, as the JAX ``while_loop`` leaves them. A sweep runs the
    run max along rows, then along columns; sweeps repeat until no label of
    any image changes, one convergence test (one host sync) per sweep for
    the whole batch. Labels only grow and are bounded by the largest id, so
    the sweeps reach their fixpoint."""
    b, h, w = mask.shape
    ids = torch.arange(1, h * w + 1, dtype=torch.float32, device=mask.device).reshape(1, h, w)
    cur = torch.where(mask, ids, torch.zeros((), device=mask.device))
    mask_t = mask.transpose(1, 2).contiguous()
    sweeps = 0
    while True:
        new = _run_max(cur, mask)
        new = _run_max(new.transpose(1, 2).contiguous(), mask_t).transpose(1, 2)
        sweeps += 1
        if torch.equal(new, cur):
            return cur, sweeps
        cur = new


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 4-connected component of each (B, H, W) mask,
    exactly, for any shape of region (spirals and serpentines included).
    Ties in area go to the component with the smaller label, as JAX's
    argmax does. An empty mask stays empty."""
    b, h, w = mask.shape
    labels, _ = component_labels(mask)
    li = labels.to(torch.int64).reshape(b, -1)
    areas = torch.zeros((b, h * w + 1), dtype=torch.int64, device=mask.device)
    areas.scatter_add_(1, li, torch.ones_like(li))
    areas[:, 0] = 0  # background
    best = torch.argmax(areas, dim=1)
    keep = (labels == best.to(torch.float32)[:, None, None]) & mask
    return keep & (best > 0)[:, None, None]


def mask_bbox(mask: torch.Tensor, margin: int = 20) -> torch.Tensor:
    """(B, H, W) bool -> (B, 4) int32 [x_min, y_min, x_max, y_max] with
    +-margin, clamped (reference getBox, extract_dataset.py:298-313). An
    empty mask gives zeros."""
    b, h, w = mask.shape
    dev = mask.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None].expand(b, h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :].expand(b, h, w)
    big = torch.full((), 1 << 30, dtype=torch.int32, device=dev)
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    x_min = torch.where(mask, xs, big).amin(dim=(1, 2))
    y_min = torch.where(mask, ys, big).amin(dim=(1, 2))
    x_max = torch.where(mask, xs, neg).amax(dim=(1, 2))
    y_max = torch.where(mask, ys, neg).amax(dim=(1, 2))
    box = torch.stack([
        torch.clamp(x_min - margin, min=0), torch.clamp(y_min - margin, min=0),
        torch.clamp(x_max + margin, max=w), torch.clamp(y_max + margin, max=h),
    ], dim=1)
    return torch.where(mask.any(dim=(1, 2))[:, None], box, torch.zeros_like(box))


def composite_gray(image: torch.Tensor, mask: torch.Tensor,
                   bg=(127.0, 127.0, 127.0)) -> torch.Tensor:
    """Keep (B, 3, H, W) ``image`` in [0, 1] where the (B, H, W) mask is
    set, a gray background (given in 0-255) elsewhere."""
    bgc = torch.tensor(bg, dtype=image.dtype, device=image.device) / 255.0
    return torch.where(mask[:, None], image, bgc[None, :, None, None])

"""Host-side image transforms (numpy, HWC).

The parts of edgestyle_tpu/data/transforms.py that the port needs, copied (the
port imports nothing of the JAX package): so far the nearest-neighbour
resize of ``apps/tryon.py::load_image_512``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def resize_nearest(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize, HWC."""
    h, w = img.shape[:2]
    th, tw = size_hw
    ri = (np.arange(th) * (h / th)).astype(np.int64).clip(0, h - 1)
    ci = (np.arange(tw) * (w / tw)).astype(np.int64).clip(0, w - 1)
    return img[ri][:, ci]

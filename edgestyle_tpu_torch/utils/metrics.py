"""Image quality metrics: SSIM, PSNR, MAE and the CLIP score.

Counterpart of edgestyle_tpu/utils/metrics.py, on NHWC tensors as the JAX
package takes them (the grids and images of validation are HWC). SSIM's
Gaussian window is a depthwise ``F.conv2d`` (a metric, not a kernel of the
port); the CLIP score takes an image-encode function, e.g. the miner's
(data/prompts.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per image of (B, H, W, C) images (per-channel windows,
    valid padding, Wang et al.'s constants)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    ch = a.shape[-1]
    kern = _gaussian_window(window_size, sigma).to(a.device).expand(ch, 1, -1, -1)

    def filt(x):
        return F.conv2d(x.float().permute(0, 3, 1, 2), kern, groups=ch)

    a, b = a.float(), b.float()
    mu_a, mu_b = filt(a), filt(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    s_aa = filt(a * a) - mu_aa
    s_bb = filt(b * b) - mu_bb
    s_ab = filt(a * b) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return (num / den).mean(dim=(1, 2, 3))


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = (a.float() - b.float()).square().mean(dim=tuple(range(1, a.ndim)))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean(dim=tuple(range(1, a.ndim)))


def clip_score(encode_image_fn, images: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between the images' embeddings and given text embeds."""
    img = encode_image_fn(images)
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1, keepdim=True)
    return (img * txt).sum(dim=-1)

"""CLIP vision tower (ViT-L/14) of the prompt miner and the dataset's pair
filter.

Counterpart of edgestyle_tpu/models/clip_vision.py: a 14x14 stride-14
patch conv without bias, the class token, the position embedding,
``pre_layrnorm``, 24 pre-LN quick-GELU layers (the text tower's
:func:`~edgestyle_tpu_torch.models.clip_text.clip_layer` with an all-zero
mask) and ``post_layernorm`` on the class token;
:class:`CLIPVisionModelWithProjection` adds the bias-free
``visual_projection`` to the 768-d shared space. At 224 px the tower
attends over 257 tokens, plain PyTorch (XLA in the JAX package: below the
flash kernel's threshold).

:func:`clip_preprocess` is ``jax.image.resize(..., "bicubic")`` to 224 px
and CLIP's normalisation. That resize is Keys' cubic with a = -0.5,
antialiased on a downscale (the kernel widened by in/out, each output's
weights renormalised), which is neither ``F.interpolate(mode="bicubic")``
(a = -0.75, no antialiasing; ops/resize.py::torch_bicubic_resize, SAM's)
nor its ``antialias=True``: the weights are two dense (out, in) matrices
built on the host in JAX's fp32 arithmetic and applied as two products.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core.params import param, sub
from edgestyle_tpu_torch.core.porting import KeyMapper
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig, clip_layer
from edgestyle_tpu_torch.models.layers import dense, layer_norm_block

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def as_layer_cfg(self) -> CLIPTextConfig:
        """The text tower's layer at this width (same pre-LN block)."""
        return CLIPTextConfig(hidden_size=self.hidden_size, num_heads=self.num_heads,
                              intermediate_size=self.intermediate_size,
                              layer_norm_eps=self.layer_norm_eps)


class CLIPVisionEncoder:
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype

    def __call__(self, p, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pixel_values (B, 3, 224, 224), CLIP-normalised ->
        {'last_hidden_state': (B, 1 + P, C), 'pooled_output': the class
        token after post_layernorm, (B, C)}, as HF CLIPVisionModel."""
        cfg, dt = self.cfg, self.dtype
        c, ps = cfg.hidden_size, cfg.patch_size
        b = pixel_values.shape[0]
        w = param(sub(p, "patch_embedding"), "kernel", (c, 3, ps, ps))
        x = F.conv2d(pixel_values.to(dt), w.to(dt), stride=ps)
        x = x.flatten(2).transpose(1, 2)  # (B, P, C), patches in row-major order
        cls = param(p, "class_embedding", (c,), "normal0.01")
        x = torch.cat([cls.to(x.dtype).expand(b, 1, c), x], dim=1)
        pos = param(p, "position_embedding", (1 + cfg.num_patches, c), "normal0.01")
        x = x + pos[None].to(x.dtype)
        x = layer_norm_block(sub(p, "pre_layrnorm"), x, cfg.layer_norm_eps)
        zero_mask = torch.zeros((1, 1, 1, 1), device=x.device)  # no causal mask
        lcfg = cfg.as_layer_cfg()
        for i in range(cfg.num_layers):
            x = clip_layer(sub(p, f"layers_{i}"), x, zero_mask, lcfg, dt)
        pooled = layer_norm_block(sub(p, "post_layernorm"), x[:, 0], cfg.layer_norm_eps)
        return {"last_hidden_state": x, "pooled_output": pooled}


class CLIPVisionModelWithProjection:
    """The encoder (params ``vision_model``) and the bias-free
    ``visual_projection`` of its pooled output (``image_embeds``)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.vision_model = CLIPVisionEncoder(cfg, dtype)

    def __call__(self, p, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.vision_model(sub(p, "vision_model"), pixel_values)
        proj = dense(sub(p, "visual_projection"), out["pooled_output"], self.cfg.projection_dim,
                     self.dtype, use_bias=False)
        return {**out, "image_embeds": proj}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5 (jax.image's), in fp32."""
    f32 = np.float32
    x = np.abs(x).astype(f32)
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= 2.0, f32(0.0), out).astype(f32)


@functools.lru_cache(maxsize=None)
def _cubic_weights(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) fp32 weights of jax.image.resize's antialiased Keys cubic
    (``jax._src.image.scale.compute_weight_mat``), in its fp32 arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(dist)  # (in, out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


def clip_preprocess(img01: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> (B, 3, image_size, image_size) fp32:
    jax.image.resize's antialiased bicubic, then CLIP's normalisation."""
    x = img01.float()
    h, w = x.shape[-2:]
    wy = torch.from_numpy(_cubic_weights(image_size, h)).to(x.device)
    wx = torch.from_numpy(_cubic_weights(image_size, w)).to(x.device)
    x = torch.matmul(torch.matmul(wy, x), wx.t())
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def port_clip_vision_state_dict(sd, num_layers: int = 24) -> Dict:
    """HF CLIPVisionModel(WithProjection) state dict (``vision_model.*``,
    ``visual_projection.weight``) -> flat {path: leaf} of
    :class:`CLIPVisionModelWithProjection`'s tree; the I64 ``position_ids``
    buffer is dropped."""
    layer = "(" + "|".join(str(i) for i in range(num_layers)) + ")"
    m = KeyMapper()
    m.rule(r"vision_model\.embeddings\.patch_embedding\.weight",
           "vision_model.patch_embedding.kernel")
    m.rule(r"vision_model\.embeddings\.class_embedding", "vision_model.class_embedding")
    m.rule(r"vision_model\.embeddings\.position_embedding\.weight",
           "vision_model.position_embedding")
    m.rule(r"vision_model\.embeddings\.position_ids", None)
    m.norm(r"vision_model\.pre_layrnorm", "vision_model.pre_layrnorm")
    m.norm(r"vision_model\.post_layernorm", "vision_model.post_layernorm")
    p, q = rf"vision_model\.encoder\.layers\.{layer}", r"vision_model.layers_\1"
    m.norm(p + r"\.(layer_norm[12])", q + r".\2")
    m.module(p + r"\.self_attn\.([qkv]_proj|out_proj)", q + r".self_attn.\2")
    m.module(p + r"\.mlp\.(fc[12])", q + r".\2")
    m.rule(r"visual_projection\.weight", "visual_projection.kernel")
    return m.apply(sd)

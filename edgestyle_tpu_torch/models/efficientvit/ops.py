"""EfficientViT building blocks.

Counterpart of edgestyle_tpu/models/efficientvit/ops.py (the reference's
efficientvit/models/nn/ops.py), each block a function of its param
subtree ``p`` with the JAX module's name in snake case: ``conv_layer``
(ConvLayer: conv + norm + act), ``ds_conv``, ``mb_conv``,
``fused_mb_conv``, ``res_block``, ``lite_mla`` (LiteMLA, relu-linear
multi-scale attention) and ``efficientvit_block``. Images are NCHW.

Types flow as in the JAX package: a conv casts its input and weights to
the compute ``dtype``; the inference-form BatchNorm (scale, bias, mean and
var, all fp32 params) computes in fp32 and the conv layer casts its result
back to ``dtype``; LayerNorm2d (channel-only, per position) takes fp32
statistics and returns its input's type; the relu-linear attention runs in
fp32 whatever ``dtype`` is. GELU is the tanh approximation (the reference's
act registry).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core.params import param, sub


def act_fn(name: Optional[str]):
    if name is None:
        return None
    return {
        "relu": F.relu,
        "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
        "hswish": F.hardswish,
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


def batch_norm_2d(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm: (x - mean) * scale / sqrt(var + eps) + bias, fp32 out."""
    c = x.shape[1]
    scale = param(p, "scale", (c,), "ones", fp32=True)
    bias = param(p, "bias", (c,), "zeros", fp32=True)
    mean = param(p, "mean", (c,), "zeros", fp32=True)
    var = param(p, "var", (c,), "ones", fp32=True)
    inv = scale * torch.rsqrt(var + eps)
    return (x.float() - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None]


def layer_norm_2d(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channels at each position (torch LayerNorm2d,
    efficientvit/models/nn/norm.py:16-22), two-pass fp32 statistics."""
    c = x.shape[1]
    scale = param(p, "scale", (c,), "ones", fp32=True)
    bias = param(p, "bias", (c,), "zeros", fp32=True)
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale[:, None, None] + bias[:, None, None]
    return out.to(x.dtype)


def conv2d(p, x: torch.Tensor, out_channels: int, kernel_size: int, dtype, stride: int = 1,
           groups: int = 1, use_bias: bool = True) -> torch.Tensor:
    """nn.Conv with symmetric k // 2 padding, in ``dtype``."""
    w = param(p, "kernel", (out_channels, x.shape[1] // groups, kernel_size, kernel_size))
    b = param(p, "bias", (out_channels,), "zeros").to(dtype) if use_bias else None
    return F.conv2d(x.to(dtype), w.to(dtype), b, stride=stride, padding=kernel_size // 2,
                    groups=groups)


def conv_layer(p, x, out_channels: int, kernel_size: int = 3, stride: int = 1,
               groups: int = 1, use_bias: bool = False, norm: Optional[str] = "bn",
               act: Optional[str] = "gelu", norm_eps: float = 1e-5,
               dtype=torch.float32) -> torch.Tensor:
    x = conv2d(sub(p, "conv"), x, out_channels, kernel_size, dtype, stride, groups, use_bias)
    if norm == "bn":
        x = batch_norm_2d(sub(p, "norm"), x, norm_eps).to(dtype)
    elif norm == "ln2d":
        x = layer_norm_2d(sub(p, "norm"), x, norm_eps).to(dtype)
    elif norm is not None:
        raise ValueError(norm)
    a = act_fn(act)
    return a(x) if a is not None else x


def ds_conv(p, x, out_channels: int, stride: int = 1, use_bias=(False, False),
            norm=("bn", "bn"), act=("relu6", None), norm_eps: float = 1e-5,
            dtype=torch.float32):
    c = x.shape[1]
    x = conv_layer(sub(p, "depth_conv"), x, c, 3, stride, groups=c, use_bias=use_bias[0],
                   norm=norm[0], act=act[0], norm_eps=norm_eps, dtype=dtype)
    return conv_layer(sub(p, "point_conv"), x, out_channels, 1, use_bias=use_bias[1],
                      norm=norm[1], act=act[1], norm_eps=norm_eps, dtype=dtype)


def mb_conv(p, x, out_channels: int, stride: int = 1, expand_ratio: float = 6,
            use_bias=(False, False, False), norm=("bn", "bn", "bn"),
            act=("relu6", "relu6", None), norm_eps: float = 1e-5, dtype=torch.float32):
    mid = round(x.shape[1] * expand_ratio)
    x = conv_layer(sub(p, "inverted_conv"), x, mid, 1, use_bias=use_bias[0], norm=norm[0],
                   act=act[0], norm_eps=norm_eps, dtype=dtype)
    x = conv_layer(sub(p, "depth_conv"), x, mid, 3, stride, groups=mid, use_bias=use_bias[1],
                   norm=norm[1], act=act[1], norm_eps=norm_eps, dtype=dtype)
    return conv_layer(sub(p, "point_conv"), x, out_channels, 1, use_bias=use_bias[2],
                      norm=norm[2], act=act[2], norm_eps=norm_eps, dtype=dtype)


def fused_mb_conv(p, x, out_channels: int, stride: int = 1, expand_ratio: float = 6,
                  use_bias=(False, False), norm=("bn", "bn"), act=("relu6", None),
                  norm_eps: float = 1e-5, dtype=torch.float32):
    mid = round(x.shape[1] * expand_ratio)
    x = conv_layer(sub(p, "spatial_conv"), x, mid, 3, stride, use_bias=use_bias[0],
                   norm=norm[0], act=act[0], norm_eps=norm_eps, dtype=dtype)
    return conv_layer(sub(p, "point_conv"), x, out_channels, 1, use_bias=use_bias[1],
                      norm=norm[1], act=act[1], norm_eps=norm_eps, dtype=dtype)


def res_block(p, x, out_channels: int, stride: int = 1, expand_ratio: float = 1,
              use_bias=(False, False), norm=("bn", "bn"), act=("relu6", None),
              norm_eps: float = 1e-5, dtype=torch.float32):
    mid = round(x.shape[1] * expand_ratio)
    x = conv_layer(sub(p, "conv1"), x, mid, 3, stride, use_bias=use_bias[0], norm=norm[0],
                   act=act[0], norm_eps=norm_eps, dtype=dtype)
    return conv_layer(sub(p, "conv2"), x, out_channels, 3, 1, use_bias=use_bias[1],
                      norm=norm[1], act=act[1], norm_eps=norm_eps, dtype=dtype)


def relu_linear_attention(qkv: torch.Tensor, dim: int, eps: float = 1e-15) -> torch.Tensor:
    """LiteMLA's core (reference ops.py:397-434) in fp32, whatever qkv's
    type. qkv: (B, heads*3*dim, H, W), each head's channels [q|k|v] blocks
    of ``dim``. Returns (B, heads*dim, H, W) fp32:
    out = relu(q)·(relu(k)ᵀ·[v;1]) divided by its last column."""
    b, c, h, w = qkv.shape
    n = h * w
    heads = c // (3 * dim)
    x = qkv.float().reshape(b, heads, 3 * dim, n).transpose(2, 3)  # (B, heads, N, 3d)
    q = F.relu(x[..., :dim])
    k = F.relu(x[..., dim:2 * dim])
    v = x[..., 2 * dim:]
    v1 = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)  # (B, heads, N, d+1)
    kv = torch.matmul(k.transpose(2, 3), v1)  # (B, heads, d, d+1)
    out = torch.matmul(q, kv)  # (B, heads, N, d+1)
    out = out[..., :-1] / (out[..., -1:] + eps)
    return out.transpose(2, 3).reshape(b, heads * dim, h, w)


def lite_mla(p, x, out_channels: int, dim: int = 8, heads_ratio: float = 1.0,
             scales: Tuple[int, ...] = (5,), norm=(None, "bn"), norm_eps: float = 1e-5,
             dtype=torch.float32, eps: float = 1e-15):
    """1x1 qkv conv -> per scale a depthwise s x s and a grouped 1x1
    aggregation -> relu-linear attention of each -> 1x1 proj (+bn)."""
    heads = int(x.shape[1] // dim * heads_ratio)
    total = heads * dim
    qkv = conv_layer(sub(p, "qkv"), x, 3 * total, 1, use_bias=False, norm=norm[0], act=None,
                     norm_eps=norm_eps, dtype=dtype)
    multi = [qkv]
    for i, s in enumerate(scales):
        y = conv2d(sub(p, f"aggreg_{i}_depth"), qkv, 3 * total, s, dtype, groups=3 * total,
                   use_bias=False)
        y = conv2d(sub(p, f"aggreg_{i}_point"), y, 3 * total, 1, dtype, groups=3 * heads,
                   use_bias=False)
        multi.append(y)
    out = torch.cat([relu_linear_attention(m, dim, eps).to(dtype) for m in multi], dim=1)
    return conv_layer(sub(p, "proj"), out, out_channels, 1, use_bias=False, norm=norm[1],
                      act=None, norm_eps=norm_eps, dtype=dtype)


def efficientvit_block(p, x, dim: int = 32, expand_ratio: float = 6, act: str = "hswish",
                       norm_eps: float = 1e-5, dtype=torch.float32):
    """LiteMLA then MBConv, both residual (reference ops.py:458-492)."""
    c = x.shape[1]
    x = x + lite_mla(sub(p, "context_module"), x, c, dim=dim, norm=(None, "bn"),
                     norm_eps=norm_eps, dtype=dtype)
    return x + mb_conv(sub(p, "local_module"), x, c, expand_ratio=expand_ratio,
                       use_bias=(True, True, False), norm=(None, None, "bn"),
                       act=(act, act, None), norm_eps=norm_eps, dtype=dtype)

"""Building blocks of the SD1.5 family (VAE / UNet / ControlNet).

Counterpart of edgestyle_tpu/models/layers.py. Each block is a function of
its param subtree ``p`` (core/params.py) and its inputs; images are NCHW in
``channels_last`` memory, token sequences (B, N, C). Types flow as in the
JAX package: a Dense or conv casts its input and weights to the compute
``dtype``, norms return their input's dtype, and residual sums promote.
Inside ``ops.tp.model_parallel`` an attention and a GEGLU feed-forward
whose kernels hold a shard (core/partitioning.py) run tensor-parallel:
:func:`column_parallel` tells, :func:`row_dense` sums the partial products.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core.params import param, sub
from edgestyle_tpu_torch.ops import quant, tp
from edgestyle_tpu_torch.ops.attention import multi_head_attention
from edgestyle_tpu_torch.ops.fused_conv import norm_act_conv3x3
from edgestyle_tpu_torch.ops.norms import cast, group_norm, layer_norm
from edgestyle_tpu_torch.ops.tome import build_merge


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0, max_period: int = 10000):
    """Sinusoidal embedding (diffusers get_timestep_embedding semantics)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


# ------------------------------------------------------------ primitives
def norm_params(p, ch: int):
    return (param(p, "scale", (ch,), "ones", fp32=True),
            param(p, "bias", (ch,), "zeros", fp32=True))


def dense(p, x: torch.Tensor, features: int, dtype, use_bias: bool = True) -> torch.Tensor:
    """nn.Dense counterpart. Under int8 serving (ops/quant.py) a pre-quantised
    kernel, or a large token matmul inside the quantised scope, runs int8."""
    w = param(p, "kernel", (features, x.shape[-1]))
    b = param(p, "bias", (features,), "zeros") if use_bias else None
    if quant.is_prequant(w):
        if x.ndim < 3:
            return quant.dequantized_dense(x, w, b, dtype)
        return quant.quant_dense(x, w, b, dtype)
    if quant.active() and quant.dense_quantizable(x, features):
        return quant.quant_dense(x, w, b, dtype)
    return F.linear(cast(x, dtype), cast(w, dtype), cast(b, dtype))


def column_parallel(p, name: str, features: int) -> bool:
    """True where Dense ``name`` of ``p`` holds this rank's rows of a
    column-parallel kernel (core/partitioning.py; a pre-quantised kernel's
    int8 rows too) inside ``tp.model_parallel``; always False outside it."""
    if tp.group() is None:
        return False
    w = p[name]["kernel"]
    return (w.q if quant.is_prequant(w) else w).shape[0] != features


def row_dense(p, x: torch.Tensor, features: int, dtype, sharded: bool) -> torch.Tensor:
    """The Dense after a column-parallel one. With ``sharded`` (``x`` holds
    this rank's share of the features, the kernel the matching columns) the
    partial products are all-reduced over the model group and the bias is
    added once, after the sum; under int8, where the single process's Dense
    at the global width would quantise, the int32 products are
    (ops/quant.py::quant_dense_row_parallel). Otherwise :func:`dense`."""
    if not sharded:
        return dense(p, x, features, dtype)
    w = param(p, "kernel", (features, x.shape[-1]))
    b = param(p, "bias", (features,), "zeros")
    if quant.is_prequant(w) or (quant.active() and quant.dense_quantizable(
            x, features, in_features=x.shape[-1] * tp.size())):
        return quant.quant_dense_row_parallel(x, w, b, dtype)
    return tp.reduce_from_model(F.linear(cast(x, dtype), cast(w, dtype))) + cast(b, dtype)


def conv(p, x: torch.Tensor, features: int, kernel_size: int, dtype, stride: int = 1,
         padding=1, init: str = "lecun") -> torch.Tensor:
    """nn.Conv counterpart. ``padding``: int (symmetric) or (top, bottom,
    left, right). Under int8 serving a pre-quantised kernel, or a conv with
    Cin and Cout >= 64 inside the quantised scope, runs int8."""
    w = param(p, "kernel", (features, x.shape[1], kernel_size, kernel_size), init)
    b = param(p, "bias", (features,), "zeros")
    if quant.is_prequant(w) or (quant.active() and quant.conv_quantizable(x, features)):
        return quant.quant_conv(x, w, b, dtype, stride, padding)
    x = cast(x, dtype)
    if not isinstance(padding, int):
        top, bottom, left, right = padding
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    return F.conv2d(x, cast(w, dtype), cast(b, dtype), stride=stride, padding=padding)


def pointwise(p, tokens: torch.Tensor, features: int, dtype) -> torch.Tensor:
    """A 1x1 conv (OIHW kernel) applied to (B, N, C) tokens; int8 as
    :func:`conv` decides it (the conv's channel gate, not the Dense's token
    gate: JAX runs this layer as an nn.Conv on the image)."""
    w = param(p, "kernel", (features, tokens.shape[-1], 1, 1))
    b = param(p, "bias", (features,), "zeros")
    if quant.is_prequant(w) or (
            quant.active() and min(tokens.shape[-1], features) >= quant.MIN_QUANT_CHANNELS):
        return quant.quant_dense(tokens, w, b, dtype)
    return F.linear(cast(tokens, dtype), cast(w.flatten(1), dtype), cast(b, dtype))


def to_tokens(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def from_tokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = t.shape
    return t.reshape(b, h, w, c).permute(0, 3, 1, 2)


def group_norm_block(p, x, num_groups: int = 32, eps: float = 1e-5, act=None):
    scale, bias = norm_params(p, x.shape[1])
    return group_norm(x, scale, bias, num_groups, eps, act=act)


def layer_norm_block(p, x, eps: float = 1e-5):
    scale, bias = norm_params(p, x.shape[-1])
    return layer_norm(x, scale, bias, eps)


# ---------------------------------------------------------------- blocks
def timestep_mlp(p, t_emb, time_embed_dim: int, dtype):
    """TimestepEmbedding: linear -> silu -> linear."""
    h = dense(sub(p, "linear_1"), t_emb, time_embed_dim, dtype)
    h = F.silu(h)
    return dense(sub(p, "linear_2"), h, time_embed_dim, dtype)


def _conv3x3_params(p, cin: int, cout: int):
    return (param(p, "kernel", (cout, cin, 3, 3)), param(p, "bias", (cout,), "zeros"))


def resnet_block(p, x, temb: Optional[torch.Tensor], out_channels: int, dtype,
                 eps: float = 1e-5, use_time_emb: bool = True):
    """diffusers ResnetBlock2D: GN->silu->conv, (+time proj), GN->silu->conv,
    skip (1x1 if channels change). Both GN->silu->conv chains go through
    ops.fused_conv.norm_act_conv3x3."""
    in_ch = x.shape[1]
    g1, b1 = norm_params(sub(p, "norm1"), in_ch)
    k1, kb1 = _conv3x3_params(sub(p, "conv1"), in_ch, out_channels)
    h = norm_act_conv3x3(x, g1, b1, k1, kb1, num_groups=32, eps=eps, dtype=dtype)
    if use_time_emb and temb is not None:
        t = dense(sub(p, "time_emb_proj"), F.silu(temb), out_channels, dtype)
        h = h + t[:, :, None, None]
    g2, b2 = norm_params(sub(p, "norm2"), out_channels)
    k2, kb2 = _conv3x3_params(sub(p, "conv2"), out_channels, out_channels)
    h = norm_act_conv3x3(h, g2, b2, k2, kb2, num_groups=32, eps=eps, dtype=dtype)
    if in_ch != out_channels:
        x = conv(sub(p, "conv_shortcut"), x, out_channels, 1, dtype, padding=0)
    return x + h


def downsample(p, x, out_channels: int, dtype, asymmetric_pad: bool = False):
    """Stride-2 3x3 conv; the VAE pads (0,1,0,1), the UNet symmetrically."""
    pad = (0, 1, 0, 1) if asymmetric_pad else 1
    return conv(sub(p, "conv"), x, out_channels, 3, dtype, stride=2, padding=pad)


def upsample(p, x, out_channels: int, dtype):
    """Nearest 2x, then a 3x3 conv."""
    x = F.interpolate(x, scale_factor=2.0, mode="nearest")
    return conv(sub(p, "conv"), x, out_channels, 3, dtype)


def vae_attention(p, x, dtype):
    """Single-head spatial self-attention of the VAE mid block (the plain
    attention, as the JAX block forces impl='xla': its head dim of 512 is
    beyond the flash kernel's)."""
    b, c, h, w = x.shape
    y = to_tokens(group_norm_block(sub(p, "group_norm"), x, 32, 1e-6))
    q = dense(sub(p, "to_q"), y, c, dtype)
    k = dense(sub(p, "to_k"), y, c, dtype)
    v = dense(sub(p, "to_v"), y, c, dtype)
    out = multi_head_attention(q, k, v, num_heads=1)
    out = dense(sub(p, "to_out"), out, c, dtype)
    return x + from_tokens(out, h, w)


def cross_attention(p, x, context, num_heads: int, dtype):
    """Multi-head attention; tensor-parallel, with q/k/v column-parallel and
    to_out row-parallel, where its kernels hold a shard: this rank's
    num_heads / tp heads."""
    c = x.shape[-1]
    split = column_parallel(p, "to_q", c)
    if split:
        context = None if context is None else tp.copy_to_model(context)
        x = tp.copy_to_model(x)
    context = x if context is None else context
    q = dense(sub(p, "to_q"), x, c, dtype, use_bias=False)
    k = dense(sub(p, "to_k"), context, c, dtype, use_bias=False)
    v = dense(sub(p, "to_v"), context, c, dtype, use_bias=False)
    out = multi_head_attention(q, k, v, num_heads * q.shape[-1] // c)
    return row_dense(sub(p, "to_out"), out, c, dtype, split)


def geglu_ff(p, x, dtype):
    """GEGLU feed-forward. Tensor-parallel where proj_in holds a shard: its
    rows are this rank's share of the hidden half and the same share of the
    gate half (core/partitioning.py), so the local chunk pairs up, and
    proj_out is row-parallel."""
    c = x.shape[-1]
    split = column_parallel(p, "proj_in", c * 8)
    if split:
        x = tp.copy_to_model(x)
    h = dense(sub(p, "proj_in"), x, c * 8, dtype)
    h, gate = h.chunk(2, dim=-1)
    h = h * F.gelu(gate)  # exact (erf) GELU
    return row_dense(sub(p, "proj_out"), h, c, dtype, split)


def transformer_block(p, x, context, num_heads: int, dtype, hw=None, tome=None):
    """LN->self-attn, LN->cross-attn, LN->GEGLU FF, all residual. With a
    ``tome`` config (ops/tome.py) that applies at this level's token count
    and the level's ``hw``, the self-attention (and with ``merge_mlp`` the
    feed-forward) runs on merged tokens, matched on the block's input."""
    n = x.shape[1]
    if tome is not None and hw is not None and tome.applies(n):
        merge, unmerge, _ = build_merge(x, hw[0], hw[1], int(tome.ratio * n))
        x = x + unmerge(cross_attention(sub(p, "attn1"),
                                        merge(layer_norm_block(sub(p, "norm1"), x)), None,
                                        num_heads, dtype))
    else:
        merge = None
        x = x + cross_attention(sub(p, "attn1"), layer_norm_block(sub(p, "norm1"), x), None,
                                num_heads, dtype)
    x = x + cross_attention(sub(p, "attn2"), layer_norm_block(sub(p, "norm2"), x), context,
                            num_heads, dtype)
    if merge is not None and tome.merge_mlp:
        return x + unmerge(geglu_ff(sub(p, "ff"), merge(layer_norm_block(sub(p, "norm3"), x)),
                                    dtype))
    return x + geglu_ff(sub(p, "ff"), layer_norm_block(sub(p, "norm3"), x), dtype)


def transformer_2d(p, x, context, num_heads: int, dtype, depth: int = 1, tome=None):
    """GN -> 1x1 proj_in -> transformer blocks over the h*w tokens -> 1x1
    proj_out -> residual (SD1.5: use_linear_projection=False, depth 1)."""
    b, c, h, w = x.shape
    y = to_tokens(group_norm_block(sub(p, "norm"), x, 32, 1e-6))
    y = pointwise(sub(p, "proj_in"), y, c, dtype)
    for i in range(depth):
        y = transformer_block(sub(p, f"blocks_{i}"), y, context, num_heads, dtype, hw=(h, w),
                              tome=tome)
    y = pointwise(sub(p, "proj_out"), y, c, dtype)
    return from_tokens(y, h, w) + x

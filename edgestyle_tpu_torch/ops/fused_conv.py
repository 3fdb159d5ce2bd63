"""Fused GroupNorm -> SiLU -> 3x3 conv: the CUDA kernel and its plain version.

Counterpart of edgestyle_tpu/ops/fused_conv.py (``_kernel`` /
``_pallas_forward`` / ``_fused`` / ``norm_act_conv3x3``). The GroupNorm
statistics stay plain fp32 torch ops (single-pass for bf16, as in JAX, where
XLA reduces them outside the Pallas kernel) and are folded into a
per-(batch, channel) scale s and shift t; ``kernels/fused_conv.cu`` then
computes ``conv3x3(silu(x*s + t)) + bias`` without writing the activated
image. :func:`norm_act_conv3x3_reference` is the plain version
(``group_norm(act=silu)`` -> ``F.conv2d`` -> + bias, as JAX's
``_reference``): the CPU path and the test oracle, never a fallback on the
card. Both go through :class:`NormActConv3x3`, the counterpart of the
``_fused`` custom VJP: its forward launches the kernel on CUDA tensors (every
shape) and runs the plain version on CPU tensors; its backward recomputes
the plain version and returns its vjp, as ``_fused_bwd`` does (the JAX
package has no backward kernel for it). The raw wrapper refuses inputs that
would record a graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch import kernels
from edgestyle_tpu_torch.ops.norms import group_norm, group_norm_stats


def gn_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float):
    """Fold GroupNorm statistics and affine into fp32 (B, C) scale/shift."""
    b, c = x.shape[:2]
    mean, rstd = group_norm_stats(x, num_groups, eps)
    per = c // num_groups
    mean_c = mean.repeat_interleave(per, dim=1)
    rstd_c = rstd.repeat_interleave(per, dim=1)
    s = gamma.float()[None, :] * rstd_c
    t = beta.float()[None, :] - mean_c * s
    return s.contiguous(), t.contiguous()


def norm_act_conv3x3_reference(x, gamma, beta, weight, bias, num_groups: int = 32,
                               eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
    """Plain version: GroupNorm -> SiLU -> 3x3 conv (pad 1) + bias, in dtype."""
    h = group_norm(x, gamma, beta, num_groups, eps, act=F.silu)
    out = F.conv2d(h.to(dtype), weight.to(dtype), padding=1)
    return out + bias.to(dtype)[None, :, None, None]


def conv_splits(m: int, cin: int, cout: int, sms: int = 132) -> int:
    """How many ways the kernel splits its K loop (9*Cin/64 slices, or
    9*Cin/32 when Cin % 64 != 0): 1 when the 128x128 output tiles already
    fill the card's SMs, else enough to reach two blocks per SM, at most 16
    and keeping >= 8 slices a split."""
    tiles = -(-m // 128) * -(-cout // 128)
    if tiles >= sms:
        return 1
    slices = 9 * cin // (64 if cin % 64 == 0 else 32)
    return max(1, min(16, -(-2 * sms // tiles), slices // 8))


def fused_gn_silu_conv3x3(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (B, Cin, H, W) bf16 CUDA, s/t (B, Cin) fp32,
    weight (Cout, Cin, 3, 3) bf16 channels_last, bias (Cout,)."""
    if not x.is_cuda:
        raise ValueError("fused_gn_silu_conv3x3 needs CUDA tensors")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, s, t, weight, bias)):
        raise RuntimeError("fused_gn_silu_conv3x3 writes through raw pointers and would cut "
                           "the autograd graph: call norm_act_conv3x3, whose autograd "
                           "Function differentiates the plain version")
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError(f"the fused conv kernel takes bf16 x and weight, got "
                        f"{x.dtype} and {weight.dtype}")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not ({cout}, {cin}, 3, 3)")
    if cin % 32 or cout % 8:
        raise ValueError(f"fused conv kernel needs Cin % 32 == 0 and Cout % 8 == 0, "
                         f"got {cin} -> {cout}")
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused conv kernel needs a channels_last weight (memory O,H,W,I)")
    x = x.contiguous(memory_format=torch.channels_last)
    s = s.float().contiguous()
    t = t.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty((b, cout, h, w), device=x.device, dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    splits = conv_splits(b * h * w, cin, cout)
    ws = torch.empty((splits, b * h * w, cout) if splits > 1 else (1,), device=x.device,
                     dtype=torch.float32)
    kernels.check_aligned("fused_gn_silu_conv3x3", x=x, s=s, t=t, weight=weight)
    lib = kernels.library("fused_conv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_gn_silu_conv3x3(x.data_ptr(), s.data_ptr(), t.data_ptr(),
                                    weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                    ws.data_ptr(), b, h, w, cin, cout, splits, stream)
    kernels.check(err, "fused_gn_silu_conv3x3")
    kernels.LAUNCHES["fused_gn_silu_conv3x3"] += 1
    return out


class NormActConv3x3(torch.autograd.Function):
    """The ``_fused`` custom VJP: the forward takes the GN statistics and
    launches the kernel (the plain version on CPU tensors); the backward
    recomputes :func:`norm_act_conv3x3_reference` and returns its vjp for
    x, gamma, beta, weight and bias."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, bias, num_groups, eps, dtype):
        if x.is_cuda:
            s, t = gn_scale_shift(x, gamma, beta, num_groups, eps)
            out = fused_gn_silu_conv3x3(x.to(dtype), s, t, weight, bias)
        else:
            out = norm_act_conv3x3_reference(x, gamma, beta, weight, bias, num_groups, eps,
                                             dtype)
        ctx.save_for_backward(x, gamma, beta, weight, bias)
        ctx.args = (num_groups, eps, dtype)
        return out

    @staticmethod
    def backward(ctx, grad):
        inputs = [a.detach().requires_grad_(need)
                  for a, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [a for a in inputs if a.requires_grad]
        with torch.enable_grad():
            out = norm_act_conv3x3_reference(*inputs, *ctx.args)
            got = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(got) if a.requires_grad else None for a in inputs), None, None, None)


def norm_act_conv3x3(x, gamma, beta, weight, bias, *, num_groups: int = 32,
                     eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
    """GroupNorm -> SiLU -> 3x3 SAME conv through :class:`NormActConv3x3`:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    return NormActConv3x3.apply(x, gamma, beta, weight, bias, num_groups, eps, dtype)

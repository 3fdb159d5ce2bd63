"""Fused GroupNorm -> SiLU -> 3x3 conv: two CUDA kernels and their plain versions.

Counterpart of edgestyle_tpu/ops/fused_conv.py (``_gn_scale_shift`` /
``_kernel`` / ``_pallas_forward`` / ``_fused`` / ``norm_act_conv3x3``). On
the card the op is two launches:

- ``kernels/gn_stats.cu`` reads x once and writes the fp32 per-(batch,
  channel) scale ``s = gamma * rstd`` and shift ``t = beta - mean * s``
  (:func:`gn_scale_shift_cuda`; plain version :func:`gn_scale_shift_reference`,
  single-pass moments for bf16 x and two-pass ones for fp32 x, as JAX's
  ``_moments``);
- ``kernels/fused_conv.cu`` computes ``conv3x3(bf16(silu(x*s + t))) + bias``
  on x in its own type (bf16 or fp32) without writing the activated image
  (:func:`fused_gn_silu_conv3x3`; plain version
  :func:`fused_gn_silu_conv3x3_reference`).

:func:`norm_act_conv3x3_reference` is the plain version of the whole op
(``group_norm(act=silu)`` -> ``F.conv2d`` -> + bias, as JAX's
``_reference``): the CPU path and the test oracle, never a fallback on the
card. Both go through :class:`NormActConv3x3`, the counterpart of the
``_fused`` custom VJP: its forward takes :func:`fused_route` where
:func:`takes_kernels` says so (CUDA x with a bf16 weight, every shape) and
the plain version otherwise (CPU tensors, fp32 models); its backward recomputes
the plain version and returns its vjp, as ``_fused_bwd`` does (the JAX
package has no backward kernel for it). The raw wrappers refuse inputs that
would record a graph.

The two launches are operators of ops/library.py
(``edgestyle::gn_scale_shift`` and ``edgestyle::fused_gn_silu_conv3x3``),
whose CUDA implementations are the wrappers here; :func:`fused_route`
reaches the kernels through them alone, so ``torch.export`` traces each as
one node. The conv's fake implementation gives its output channels_last
strides, as the kernel writes it.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch import kernels
from edgestyle_tpu_torch.ops import quant
from edgestyle_tpu_torch.ops.library import define
from edgestyle_tpu_torch.ops.norms import cast, group_norm, group_norm_stats

SMS = 132  # streaming multiprocessors of the H100 SXM
# The conv kernel's tiles: a block owns TILE_H x TILE_W output pixels of one
# image and 128 or 160 output channels, and walks the input channels in
# slices of SLICE (kernels/fused_conv.cu).
TILE_H, TILE_W, SLICE = 8, 16, 64
MAX_SPLITS = 16


def gn_scale_shift_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                             num_groups: int, eps: float):
    """Plain version: fold GroupNorm statistics and affine into fp32 (B, C)
    scale/shift."""
    b, c = x.shape[:2]
    mean, rstd = group_norm_stats(x, num_groups, eps)
    per = c // num_groups
    mean_c = mean.repeat_interleave(per, dim=1)
    rstd_c = rstd.repeat_interleave(per, dim=1)
    s = gamma.float()[None, :] * rstd_c
    t = beta.float()[None, :] - mean_c * s
    return s.contiguous(), t.contiguous()


@functools.lru_cache(maxsize=None)
def gn_chunks(b: int, hw: int, c: int, itemsize: int) -> int:
    """How many blocks of the statistics kernel share one image: enough for
    two blocks per SM over the batch, but each reads at least 8 KB (a few
    16-byte loads per thread, all in flight at once)."""
    return max(1, min(-(-2 * SMS // b), hw * c * itemsize // 8192, hw))


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(device: torch.device, b: int) -> torch.Tensor:
    """One int32 per image, zero between launches: the statistics kernel's
    last block of each image finds itself by it and sets it back to 0. Kept
    per device, so a call makes no fill launch."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < b:
        buf = torch.zeros(max(b, 64), device=device, dtype=torch.int32)
        _COUNTERS[device] = buf
    return buf


def gn_scale_shift_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        num_groups: int, eps: float):
    """Launch the statistics kernel: x (B, C, H, W) bf16 or fp32 CUDA,
    gamma/beta (C,) -> fp32 (B, C) s, t."""
    if not x.is_cuda:
        raise ValueError("gn_scale_shift_cuda needs CUDA tensors")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, gamma, beta)):
        raise RuntimeError("gn_scale_shift_cuda writes through raw pointers and would cut the "
                           "autograd graph: call norm_act_conv3x3")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the GN statistics kernel takes bf16 or fp32 x, got {x.dtype}")
    b, c, h, w = x.shape
    if c % num_groups or c % (16 // x.element_size()):
        raise ValueError(f"GN statistics kernel needs C % groups == 0 and 16-byte channel "
                         f"vectors, got C={c}, groups={num_groups}, {x.dtype}")
    x = x.contiguous(memory_format=torch.channels_last)
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    chunks = gn_chunks(b, h * w, c, x.element_size())
    s = torch.empty((b, c), device=x.device, dtype=torch.float32)
    t = torch.empty((b, c), device=x.device, dtype=torch.float32)
    ws = torch.empty((b, num_groups, chunks, 3), device=x.device, dtype=torch.float32)
    counters = _counters(x.device, b)
    kernels.check_aligned("gn_scale_shift", x=x)
    lib = kernels.library("gn_stats")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.gn_scale_shift(x.data_ptr(), int(x.dtype == torch.float32), gamma.data_ptr(),
                             beta.data_ptr(), s.data_ptr(), t.data_ptr(), ws.data_ptr(),
                             counters.data_ptr(), b, h * w, c, num_groups, chunks, float(eps),
                             stream)
    kernels.check(err, "gn_scale_shift")
    kernels.LAUNCHES["gn_scale_shift"] += 1
    return s, t


def _gn_fake(x, gamma, beta, num_groups, eps):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the GN statistics kernel takes bf16 or fp32 x, got {x.dtype}")
    b, c = x.shape[:2]
    return x.new_empty((b, c), dtype=torch.float32), x.new_empty((b, c), dtype=torch.float32)


GN_SCALE_SHIFT = define(
    "gn_scale_shift", "(Tensor x, Tensor gamma, Tensor beta, int num_groups, float eps) "
    "-> (Tensor, Tensor)", lambda *a: gn_scale_shift_cuda(*a), _gn_fake,
    lambda *a, **k: 0)


def gn_scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   num_groups: int, eps: float):
    """fp32 (B, C) GroupNorm scale/shift: the kernel's operator for CUDA
    tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return GN_SCALE_SHIFT(x, gamma, beta, num_groups, eps)
    return gn_scale_shift_reference(x, gamma, beta, num_groups, eps)


def fused_gn_silu_conv3x3_reference(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                                    weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the conv kernel: conv3x3(silu(x*s + t)) + bias, pad
    1. x keeps its own type (bf16 or fp32) up to the affine; the affine and
    SiLU are fp32, the activation is rounded once to the weight's type, the
    products and the bias are summed in fp32 and the sum is rounded once to
    the weight's type."""
    a = x.float() * s.float()[:, :, None, None] + t.float()[:, :, None, None]
    act = F.silu(a).to(weight.dtype)
    return F.conv2d(act.float(), weight.float(), bias.float(), padding=1).to(weight.dtype)


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int):
    """The conv kernel's grid: (tiles_h, tiles_w, block_n, cout_tiles, splits).

    A block owns a TILE_H x TILE_W pixel tile of one image and ``block_n``
    output channels: 160 where Cout is a multiple of it (SD1.5's 320, 640
    and 1280, which 128 would cover with a ragged last tile), else 128.
    When the tiles do not fill the card, the input channel slices are split
    over ``splits`` blocks whose fp32 partial sums a second kernel adds: the
    count that minimises waves per unit of work, the fewest on a tie, at
    most MAX_SPLITS and the slice count."""
    tiles_h, tiles_w = -(-h // TILE_H), -(-w // TILE_W)
    block_n = 160 if cout % 160 == 0 else 128
    cout_tiles = -(-cout // block_n)
    tiles = b * tiles_h * tiles_w * cout_tiles
    splits = 1
    if tiles < SMS:
        limit = min(MAX_SPLITS, -(-cin // SLICE))
        splits = min(range(1, limit + 1), key=lambda k: (-(-tiles * k // SMS) / k, k))
    return tiles_h, tiles_w, block_n, cout_tiles, splits


def fused_gn_silu_conv3x3(x: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch the conv kernel: x (B, Cin, H, W) bf16 or fp32 CUDA, s/t (B,
    Cin) fp32, weight (Cout, Cin, 3, 3) bf16 channels_last, bias (Cout,)
    bf16 or fp32 -> bf16 (B, Cout, H, W) channels_last."""
    if not x.is_cuda:
        raise ValueError("fused_gn_silu_conv3x3 needs CUDA tensors")
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, s, t, weight, bias)):
        raise RuntimeError("fused_gn_silu_conv3x3 writes through raw pointers and would cut "
                           "the autograd graph: call norm_act_conv3x3, whose autograd "
                           "Function differentiates the plain version")
    if x.dtype not in (torch.bfloat16, torch.float32) or weight.dtype != torch.bfloat16:
        raise TypeError(f"the fused conv kernel takes bf16 or fp32 x and bf16 weight, got "
                        f"{x.dtype} and {weight.dtype}")
    if bias.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the fused conv kernel takes a bf16 or fp32 bias, got {bias.dtype}")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not ({cout}, {cin}, 3, 3)")
    if cin % 8 or cout % 8:
        raise ValueError(f"fused conv kernel needs Cin % 8 == 0 and Cout % 8 == 0, "
                         f"got {cin} -> {cout}")
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused conv kernel needs a channels_last weight (memory O,H,W,I)")
    x = x.contiguous(memory_format=torch.channels_last)
    s = s.float().contiguous()
    t = t.float().contiguous()
    bias = bias.contiguous()
    out = torch.empty((b, cout, h, w), device=x.device, dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    _, _, block_n, _, splits = conv_plan(b, h, w, cin, cout)
    ws = torch.empty((splits, b * h * w, cout) if splits > 1 else (1,), device=x.device,
                     dtype=torch.float32)
    kernels.check_aligned("fused_gn_silu_conv3x3", x=x, s=s, t=t, weight=weight)
    lib = kernels.library("fused_conv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_gn_silu_conv3x3(x.data_ptr(), int(x.dtype == torch.float32), s.data_ptr(),
                                    t.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                    int(bias.dtype == torch.float32), out.data_ptr(),
                                    ws.data_ptr(), b, h, w, cin, cout, block_n, splits, stream)
    kernels.check(err, "fused_gn_silu_conv3x3")
    kernels.LAUNCHES["fused_gn_silu_conv3x3"] += 1
    return out


def _conv_fake(x, s, t, weight, bias):
    if x.dtype not in (torch.bfloat16, torch.float32) or weight.dtype != torch.bfloat16:
        raise TypeError(f"the fused conv kernel takes bf16 or fp32 x and bf16 weight, got "
                        f"{x.dtype} and {weight.dtype}")
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not ({cout}, {cin}, 3, 3)")
    return torch.empty((b, cout, h, w), device=x.device, dtype=torch.bfloat16,
                       memory_format=torch.channels_last)


def _conv_flops(x, s, t, weight, *args, out_shape=None, **kwargs) -> int:
    b, cin, h, w = x
    return 2 * b * h * w * cin * weight[0] * 9


FUSED_GN_SILU_CONV3X3 = define(
    "fused_gn_silu_conv3x3", "(Tensor x, Tensor s, Tensor t, Tensor weight, Tensor bias) "
    "-> Tensor", lambda *a: fused_gn_silu_conv3x3(*a), _conv_fake, _conv_flops)


def fused_route(x, gamma, beta, weight, bias, num_groups: int, eps: float,
                conv=FUSED_GN_SILU_CONV3X3):
    """The card's route of the op: the GN scale/shift, then ``conv`` (the
    kernel's operator; a test passes its plain version) on x in its own
    type. Nothing is cast on the way: an fp32 x is normalised from its fp32
    values."""
    s, t = gn_scale_shift(x, gamma, beta, num_groups, eps)
    return conv(x, s, t, weight, bias)


def takes_kernels(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """The op's dispatch rule, by device and type (the reference's
    ``_eligible`` sends non-bf16 x to XLA): the kernels take CUDA x, bf16 or
    fp32 (the LoRA trunks' first convs see fp32 x), with a bf16 weight. An
    fp32 weight, which an fp32 model has, takes the plain version, as on the
    CPU: the conv kernel multiplies bf16 operands only."""
    return x.is_cuda and weight.dtype == torch.bfloat16


def norm_act_conv3x3_reference(x, gamma, beta, weight, bias, num_groups: int = 32,
                               eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
    """Plain version: GroupNorm -> SiLU -> 3x3 conv (pad 1) + bias, in dtype."""
    h = group_norm(x, gamma, beta, num_groups, eps, act=F.silu)
    out = F.conv2d(h.to(dtype), weight.to(dtype), padding=1)
    return out + bias.to(dtype)[None, :, None, None]


class NormActConv3x3(torch.autograd.Function):
    """The ``_fused`` custom VJP: the forward takes :func:`fused_route`
    where :func:`takes_kernels` says so, cast to ``dtype`` as the plain
    version returns it, and the plain version otherwise; the backward
    recomputes
    :func:`norm_act_conv3x3_reference` and returns its vjp for x, gamma,
    beta, weight and bias."""

    @staticmethod
    def forward(ctx, x, gamma, beta, weight, bias, num_groups, eps, dtype):
        if takes_kernels(x, weight):
            out = cast(fused_route(x, gamma, beta, weight, bias, num_groups, eps), dtype)
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
    the kernels for CUDA x with a bf16 weight, the plain version otherwise
    (:func:`takes_kernels`).

    A pre-quantised ``weight`` (ops/quant.py::QuantKernel, W8A8 serving)
    takes the int8 branch first, as the JAX op does: GroupNorm -> SiLU in
    x's type, the activation quantised under the layer's key, the int8 conv
    (pad 1) and the fp32 epilogue. So under int8 no ResNet conv reaches the
    bf16 kernels."""
    if quant.is_prequant(weight):
        h = group_norm(x, gamma, beta, num_groups, eps, act=F.silu)
        return quant.quant_conv(h, weight, bias, dtype, stride=1, padding=1)
    return NormActConv3x3.apply(x, gamma, beta, weight, bias, num_groups, eps, dtype)

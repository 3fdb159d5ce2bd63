"""Chip smoke test of the PyTorch/CUDA port (edgestyle_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --profile OUT_DIR  # + a profiled B=1 generation and training step

Phases, each of which ends the run with a non-zero exit on failure:

  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. kernel phase: every hand-written kernel against its plain PyTorch
     version on the card, at the full-width shapes its path gives it (the
     fused conv and the GN statistics also on the fp32 x of the LoRA
     trunks' first convs), with its time, the plain version's time, one
     PyTorch library call of the same function as a yardstick (never used by
     the port) and the least time the card could take (the bound); and the
     fused conv's bf16 activations against bf16(exact silu), on bf16 and
     fp32 x;
  3. generation phase: the full-width SD1.5 6-branch try-on
     (``EdgeStylePipeline.__call__``, 512 px, 20 UniPC steps, bf16) from the
     port's random init, for a few requests, with the kernels' launch counts
     read around the requests against the counts the code predicts;
  4. end-to-end check: the same generation at 2 steps through the kernels
     and through the ops' plain versions, image max-abs difference under a
     stated bf16 tolerance;
  5. training phase: the ControlLoRA trainer's entry point
     (``apps/train.py::main``) at full width, 512 px, micro-batch 2, 3
     steps of Prodigy with Min-SNR-gamma 5, from the port's random init,
     with the kernels' launch counts read around the run against the counts
     the code predicts; finite losses, a monotone d, every trainable group
     moved, the frozen weights unchanged and the checkpoint read back equal;
  6. gradient check: one micro-batch's loss and trainable gradients at B=1
     through the kernels and through the ops' plain versions, the relative
     L2 difference of each trainable group and of each leaf under stated
     tolerances; then two planted faults (dq set to 0, dv set to 0), each
     of which the same check must reject;
  7. fp32 training: one step of the same entry point with
     ``--mixed_precision no`` (micro-batch 1): an fp32 model runs its long
     attentions through the flash kernels on q, k, v and dO rounded to
     bf16 (the launches of a bf16 step) and its convs through the plain
     version (no GN statistics or conv launch); the loss is finite.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``{"kernels": [...]}`` record.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published dense peaks (NVIDIA data sheet), used for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12
# Exponentials per second of the special-function units: 132 SMs x 16 ex2 per
# clock per SM (the CUDA C++ Programming Guide's arithmetic-instruction
# throughput table, compute capability 9.0) at the 1.83 GHz that the bf16
# peak above implies (989e12 / (132 SMs x 4096 flops per clock)): ~3.9e12.
PEAK_EXP_PER_S = 132 * 16 * 1.83e9

# Kernel against plain version: max-abs error <= REL_TOL * max|plain output|,
# i.e. 2 to 4 bf16 ulps (8 significant bits) of the largest output. Set from
# the output's own scale: a softmax mix of N random v is ~N(0, e/N), far
# below |v|, so an absolute limit would pass a P*V that is off by a large
# share of its output.
REL_TOL = 2.0 ** -6
LSE_TOL = 1e-2     # fp32 row logsumexp of values ~log(N) + 0.5
# GN statistics kernel against the plain statistics, relative on s and on
# mean * s in t: fp32 sums in another order, 1e-4; for bf16 x the single-pass
# variance E[x^2] - E[x]^2 loses mean^2 / var of its fp32 rounding to
# cancellation, GN_CANCEL_TOL of that ratio (a mean of +40 at a spread of
# 1.1: 1e-4 + 2.6e-3).
GN_REL_TOL = 1e-4
GN_CANCEL_TOL = 2e-6
# The conv's bf16 activations against exact silu: a fast-math silu a few
# fp32 ulps from exact moves a bf16 rounding for ~2^-13 of the values, and
# then by one ulp.
ACT_SHARE_TOL = 1e-3
E2E_TOL = 0.1      # [0,1] images after 2 bf16 steps through 3 ControlNets + UNet + VAE
# Backward kernels against the plain backward: max-abs error <= BWD_REL_TOL
# * max|plain gradient|, 2 to 4 bf16 ulps of the largest gradient: the
# kernels round P to bf16 for P^T dO (the plain version keeps it fp32, as
# the Pallas kernel does), a few fp32 ulps of S can move a bf16 rounding of
# dS, and the sums run in another order.
BWD_REL_TOL = 2.0 ** -5
# Trainable gradients through the kernels against the plain versions: per
# group, |g_kernels - g_plain|_2 <= GRAD_TOL * |g_plain|_2, and per leaf the
# same with LEAF_TOL. Both runs are bf16 through the VAE, the UNet and three
# ControlNet trunks and round at other places in every attention and conv:
# on the H100 the groups differed by 2.1e-3 to 3.6e-3 and the worst leaf (a
# mid-block adapter with 0.1% of its group's norm) by 3.1e-2. A fault that
# drops one path of a leaf's gradient is off by order 1 on that leaf but
# can hide in its group's norm: with dq set to 0 the to_q adapters of the
# long attentions were off by 1.0 and the groups by 2.8e-2 to 5.8e-2. The
# check plants that fault once and fails unless it is rejected.
GRAD_TOL = 0.02
LEAF_TOL = 0.25


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS, exps: float = 0.0):
    """The least time for the work, in ms, and what sets it: the flops at
    `peak`, the bytes at the memory rate, or the exponentials at the SFU's
    rate ("exp"), whichever takes longest."""
    times = {"operations": flops / peak, "bytes": nbytes / PEAK_BYTES,
             "exp": exps / PEAK_EXP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def time_ms(fn, iters: int = 10, warmup: int = 2, queue_ahead: bool = True,
            sleep_cycles: int = 10_000_000) -> float:
    """Milliseconds per call from CUDA events around `iters` back-to-back
    calls. With queue_ahead the calls are queued behind a sleep kernel of
    `sleep_cycles` clocks (about 5 ms by default), so the events time the
    card alone as long as the host queues every call within the sleep;
    without it, a call whose host work (Python wrappers, launches) outlasts
    its device work is timed at the host's rate, as a caller issuing the
    calls back to back sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them: every
    time in this run is read beside them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi could not report the card's name and power limit ({e})")
    if not out:
        fail("nvidia-smi listed no card")
    return out[0]


# ---------------------------------------------------------------- kernels
# (BH, N, D) at micro-batch 2 (or B=1 with its guidance pair): the UNet and
# the lora_0 trunk run 2 x 8 heads, the lora_1 trunk (branches 2 and 4
# batched) 4 x 8, the static trunk (three branches) 6 x 8; N, D are 4096, 40
# and 1024, 80.
FLASH_SHAPES = [(bh, n, d) for bh in (2 * 8, 4 * 8, 6 * 8) for n, d in ((4096, 40), (1024, 80))]
# Checked, not timed: a ragged last key tile, and the widest and narrowest
# head dims the dispatch rule sends to the kernel.
FLASH_CHECK_SHAPES = [(2, 1000, 40), (2, 1024, 128), (2, 1024, 8)]
# Backward: the UNet's up blocks and the two LoRA trunks (the static trunk
# is frozen).
FLASH_BWD_SHAPES = [(bh, n, d) for bh in (2 * 8, 4 * 8) for n, d in ((4096, 40), (1024, 80))]
# Checked, not timed: a ragged last tile, and the widest and narrowest head
# dims.
FLASH_BWD_CHECK_SHAPES = [(2, 1000, 64), (2, 1024, 128), (2, 1024, 8)]
CONV_SHAPES = [  # (B, Cin, H, W, Cout, x dtype)
    (2, 320, 64, 64, 320, torch.bfloat16),
    (2, 1920, 32, 32, 640, torch.bfloat16),
    (2, 1280, 8, 8, 1280, torch.bfloat16),
    (1, 128, 512, 512, 128, torch.bfloat16),
    # conv1 of down block 0's ResNet blocks in the LoRA trunks at B=1 (the
    # lora_0 and lora_1 trunks): x = conv_in(sample) + the fp32 VAE-branch
    # embedding stays fp32 until the first downsampler
    (2, 320, 64, 64, 320, torch.float32),
    (4, 320, 64, 64, 320, torch.float32),
]
# The GN statistics at the bf16 conv shapes, and at (2, 320, 64, 64) with
# channel means of +40: fp32 (where the two-pass variance matters) and bf16
# (where the single-pass one cancels).
GN_SHAPES = [(b, c, h, w, dt, 0.0) for b, c, h, w, _, dt in CONV_SHAPES[:4]] + [
    (2, 320, 64, 64, torch.float32, 40.0), (2, 320, 64, 64, torch.bfloat16, 40.0)]


def kernel_phase(dev):
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.ops import flash, fused_conv

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records = []

    shapes = []
    for bh, n, d in FLASH_SHAPES + FLASH_CHECK_SHAPES:
        q, k, v = (torch.randn((1, bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        err, tol, lse_err = flash_check(q, k, v, scale)
        what = (f"flash_fwd BH={bh} N={n} D={d}: max_abs_err={err:.3e} (tol {tol:.3e}) "
                f"lse_err={lse_err:.3e} (tol {LSE_TOL})")
        if not (err <= tol and lse_err <= LSE_TOL):
            print(what, flush=True)
            fail(f"flash_fwd disagrees with its plain version at {(bh, n, d)}")
        if (bh, n, d) in FLASH_CHECK_SHAPES:
            print(f"{what} (checked, not timed)", flush=True)
            continue
        ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v, scale))
        plain_ms = time_ms(lambda: flash.flash_attention_reference(q, k, v, scale), iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        b_ms, b_by = flash_bound_ms(bh, n, d)
        print(f"{what} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        shapes.append(dict(shape=[bh, n, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records.append(("flash_fwd", "edgestyle_tpu_torch/kernels/flash_fwd.cu",
                    "edgestyle_tpu/ops/flash.py:42", shapes))

    records.append(gn_phase(dev, gen))
    shapes = []
    for b, cin, h, w, cout, dt in CONV_SHAPES:
        x = torch.randn((b, cin, h, w), generator=gen, device=dev)
        if dt == torch.float32:
            x = x + 40.0
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        gamma = 1.0 + 0.1 * torch.randn((cin,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((cin,), generator=gen, device=dev)
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              / math.sqrt(9 * cin)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bias = (0.1 * torch.randn((cout,), generator=gen, device=dev)).to(torch.bfloat16)
        eps = 1e-6 if h == 512 else 1e-5
        s, t = fused_conv.gn_scale_shift(x, gamma, beta, 32, eps)
        out = fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, bias)
        torch.cuda.synchronize()
        ref = fused_conv.norm_act_conv3x3_reference(x, gamma, beta, wt, bias, 32, eps,
                                                    torch.bfloat16)
        err = (out.float() - ref.float()).abs().max().item()
        tol = REL_TOL * ref.float().abs().max().item()
        # ms: the kernel alone, on precomputed s, t; op_ms: the op the main
        # path calls (GN statistics kernel + conv kernel), like for like
        # with plain_ms; op_wall_ms: the op called back to back, host
        # included, as a caller issuing it from Python sees it
        ms = time_ms(lambda: fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, bias))
        op = lambda: fused_conv.norm_act_conv3x3(  # noqa: E731
            x, gamma, beta, wt, bias, num_groups=32, eps=eps, dtype=torch.bfloat16)
        op_ms = time_ms(op)
        op_wall_ms = time_ms(op, queue_ahead=False)
        plain_ms = time_ms(lambda: fused_conv.norm_act_conv3x3_reference(
            x, gamma, beta, wt, bias, 32, eps, torch.bfloat16))
        act = F.silu(x.float() * s[:, :, None, None] + t[:, :, None, None]).to(torch.bfloat16)
        act = act.contiguous(memory_format=torch.channels_last)
        lib_ms = time_ms(lambda: F.conv2d(act, wt, bias, padding=1))
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = b * h * w * cin * x.element_size() + 2 * b * cin * 4 + 9 * cin * cout * 2 \
            + cout * 2 + b * h * w * cout * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        splits = fused_conv.conv_plan(b, h, w, cin, cout)[4]
        print(f"fused_gn_silu_conv3x3 x=({b},{cin},{h},{w}) {str(dt)[6:]} -> {cout} "
              f"(splits {splits}): max_abs_err={err:.3e} (tol {tol:.3e}; mean |ref| "
              f"{ref.float().abs().mean().item():.3e}) ms={ms:.4f} op_ms={op_ms:.4f} "
              f"op_wall_ms={op_wall_ms:.4f} plain_ms={plain_ms:.4f} conv2d_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not err <= tol:
            fail(f"fused conv disagrees with its plain version at {(b, cin, h, w, cout, dt)}")
        shapes.append(dict(shape=[b, cin, h, w, cout], x_dtype=str(dt)[6:], splits=splits,
                           max_abs_err=err, ms=ms, op_ms=op_ms, op_wall_ms=op_wall_ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records.append(("fused_gn_silu_conv3x3", "edgestyle_tpu_torch/kernels/fused_conv.cu",
                    "edgestyle_tpu/ops/fused_conv.py:88", shapes))
    for dt in (torch.bfloat16, torch.float32):
        activation_check(dev, gen, dt)
    records += flash_bwd_phase(dev, gen)
    # launches made for the comparison do not count
    kernels.reset_launches()
    return records


def flash_bound_ms(bh: int, n: int, d: int):
    """The flash forward's bound: q, k, v read and o, lse written once;
    4*N*N*D tensor-core flops and N*N exponentials per head."""
    return bound_ms(4.0 * bh * n * n * d, 4 * bh * n * d * 2 + bh * n * 4,
                    exps=float(bh) * n * n)


def flash_check(q, k, v, scale: float, fwd=None):
    """The flash forward kernel (or `fwd`, a function of the same
    arguments) against its plain version: (max-abs error of the output, its
    tolerance REL_TOL * max |plain output|, max-abs error of lse)."""
    from edgestyle_tpu_torch.ops import flash

    out, lse = (fwd or flash.flash_attention_cuda)(q, k, v, scale)
    torch.cuda.synchronize()
    ref = flash.flash_attention_reference(q, k, v, scale)
    ref_lse = flash.flash_attention_reference_lse(q, k, scale)
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    return err, tol, (lse.reshape(ref_lse.shape) - ref_lse).abs().max().item()


def gn_phase(dev, gen):
    """The GN statistics kernel against the plain statistics (the
    composition of torch reductions it replaces), with one torch.var_mean
    over the grouped view as the library yardstick. The tolerance is
    GN_REL_TOL, loosened for bf16 x by the single-pass cancellation."""
    from edgestyle_tpu_torch.ops import fused_conv

    shapes = []
    for b, c, h, w, dt, mean in GN_SHAPES:
        x = (mean + torch.randn((b, c, h, w), generator=gen, device=dev)
             + 0.5 * torch.randn((1, c, 1, 1), generator=gen, device=dev))
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        gamma = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
        eps = 1e-6 if h == 512 else 1e-5
        s, t = fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps)
        torch.cuda.synchronize()
        rs, rt = fused_conv.gn_scale_shift_reference(x, gamma, beta, 32, eps)
        grouped = x.permute(0, 2, 3, 1).reshape(b, h * w, 32, c // 32)
        var, mu = torch.var_mean(grouped.float(), dim=(1, 3), correction=0)
        ratio = (mu.square() / var).repeat_interleave(c // 32, dim=1)
        rtol = GN_REL_TOL + (GN_CANCEL_TOL * ratio if dt == torch.bfloat16 else 0.0)
        mean_s = (mu.repeat_interleave(c // 32, dim=1) * rs).abs()
        s_err = ((s - rs).abs() / (rtol * rs.abs())).max().item()
        t_err = ((t - rt).abs() / (rtol * mean_s + 1e-5)).max().item()
        err = max((s - rs).abs().max().item(), (t - rt).abs().max().item())
        again = fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps)
        same = torch.equal(again[0], s) and torch.equal(again[1], t)
        ms = time_ms(lambda: fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps))
        plain_ms = time_ms(lambda: fused_conv.gn_scale_shift_reference(x, gamma, beta, 32, eps))
        lib_ms = time_ms(lambda: torch.var_mean(grouped, dim=(1, 3)))
        n = x.numel()
        b_ms, b_by = bound_ms(3.0 * n, n * x.element_size() + 2 * c * 4 + 2 * b * c * 4,
                              PEAK_FP32_FLOPS)
        print(f"gn_scale_shift x=({b},{c},{h},{w}) {str(dt)[6:]} mean {mean}: max_abs_err="
              f"{err:.3e}, worst error / tolerance: s {s_err:.3f}, t {t_err:.3f} (tol 1; rtol "
              f"{GN_REL_TOL} + {GN_CANCEL_TOL if dt == torch.bfloat16 else 0} * mean^2/var, "
              f"max ratio {ratio.max().item():.1f}); deterministic {same}; ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} var_mean_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
              flush=True)
        if not (s_err <= 1 and t_err <= 1 and same):
            fail(f"gn_scale_shift disagrees with the plain statistics at {(b, c, h, w, dt)}")
        shapes.append(dict(shape=[b, c, h, w], x_dtype=str(dt)[6:], mean=mean, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms))
    return ("gn_scale_shift", "edgestyle_tpu_torch/kernels/gn_stats.cu",
            "edgestyle_tpu/ops/fused_conv.py:50", shapes)


def flash_bwd_bound_ms(bh: int, n: int, d: int, products: int):
    """A flash backward kernel's bound: q, k, v, dO, lse and D read once and
    its `products` N x N x D products' outputs ((B, H, N, D) bf16 each: dq,
    or dk and dv) written once; 2*N*N*D tensor-core flops a product and N*N
    exponentials per head (P is recomputed)."""
    outs = 1 if products == 3 else 2
    nbytes = 4 * bh * n * d * 2 + 2 * bh * n * 4 + outs * bh * n * d * 2
    return bound_ms(2.0 * products * bh * n * n * d, nbytes, exps=float(bh) * n * n)


def flash_bwd_inputs(gen, dev, bh: int, n: int, d: int):
    """(q, k, v, dO, lse, D, scale) at (1, BH, N, D) bf16, lse and D from the
    forward kernel's own output."""
    from edgestyle_tpu_torch.ops import flash

    q, k, v, do = (torch.randn((1, bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash.flash_attention_cuda(q, k, v, scale)
    return q, k, v, do, lse, flash.flash_bwd_delta(out, do), scale


def flash_bwd_errors(args, dq_fn=None, dkv_fn=None):
    """The backward kernels (or dq_fn / dkv_fn, functions of the same
    arguments) against their plain versions: {name: (max-abs error,
    tolerance BWD_REL_TOL * max |plain|, max |plain|)} for dq, dk and dv;
    a name whose function is False is left out."""
    from edgestyle_tpu_torch.ops import flash

    got, ref = {}, {}
    if dq_fn is not False:
        got["dq"] = (dq_fn or flash.flash_bwd_dq_cuda)(*args)
    if dkv_fn is not False:
        got["dk"], got["dv"] = (dkv_fn or flash.flash_bwd_dkv_cuda)(*args)
    torch.cuda.synchronize()
    if "dq" in got:
        ref["dq"] = flash.flash_bwd_dq_reference(*args)
    if "dk" in got:
        ref["dk"], ref["dv"] = flash.flash_bwd_dkv_reference(*args)
    errs = {}
    for name, r in ref.items():
        rmax = r.float().abs().max().item()
        errs[name] = ((got[name].float() - r.float()).abs().max().item(), BWD_REL_TOL * rmax,
                      rmax)
    return errs


def flash_bwd_phase(dev, gen):
    """Both backward kernels against their plain versions on the forward's
    own output and lse, at the training step's shapes (timed) and at
    FLASH_BWD_CHECK_SHAPES (checked only). The library yardstick is the
    backward of F.scaled_dot_product_attention (dq, dk and dv together),
    for each of the two."""
    from edgestyle_tpu_torch.ops import flash

    dq_shapes, dkv_shapes = [], []
    for bh, n, d in FLASH_BWD_SHAPES + FLASH_BWD_CHECK_SHAPES:
        args = flash_bwd_inputs(gen, dev, bh, n, d)
        errs = flash_bwd_errors(args)
        err_txt = ", ".join(f"{k} max_abs_err={e:.3e} (tol {t:.3e}; max |ref| {m:.3e})"
                            for k, (e, t, m) in errs.items())
        if not all(e <= t for e, t, _ in errs.values()):
            print(f"flash_bwd BH={bh} N={n} D={d}: {err_txt}", flush=True)
            fail(f"the flash backward kernels disagree with their plain versions at "
                 f"{(bh, n, d)}")
        if (bh, n, d) in FLASH_BWD_CHECK_SHAPES:
            print(f"flash_bwd BH={bh} N={n} D={d}: {err_txt} (checked, not timed)", flush=True)
            continue
        ms_dq = time_ms(lambda: flash.flash_bwd_dq_cuda(*args))
        ms_dkv = time_ms(lambda: flash.flash_bwd_dkv_cuda(*args))
        plain_dq = time_ms(lambda: flash.flash_bwd_dq_reference(*args), iters=3, warmup=1)
        plain_dkv = time_ms(lambda: flash.flash_bwd_dkv_reference(*args), iters=3, warmup=1)
        lib_ms = sdpa_backward_ms(*args[:4])
        b_dq = flash_bwd_bound_ms(bh, n, d, 3)
        b_dkv = flash_bwd_bound_ms(bh, n, d, 4)
        print(f"flash_bwd BH={bh} N={n} D={d}: {err_txt}; dq ms={ms_dq:.4f} "
              f"plain_ms={plain_dq:.4f} bound_ms={b_dq[0]:.4f} ({b_dq[1]}); dkv ms={ms_dkv:.4f} "
              f"plain_ms={plain_dkv:.4f} bound_ms={b_dkv[0]:.4f} ({b_dkv[1]}); "
              f"sdpa_backward_ms={lib_ms:.4f}", flush=True)
        dq_shapes.append(dict(shape=[bh, n, d], max_abs_err=errs["dq"][0], ms=ms_dq,
                              plain_ms=plain_dq, bound_ms=b_dq[0], bound_by=b_dq[1],
                              library_ms=lib_ms))
        dkv_shapes.append(dict(shape=[bh, n, d], max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                               ms=ms_dkv, plain_ms=plain_dkv, bound_ms=b_dkv[0],
                               bound_by=b_dkv[1], library_ms=lib_ms))
    return [("flash_bwd_dq", "edgestyle_tpu_torch/kernels/flash_bwd.cu",
             "edgestyle_tpu/ops/flash.py:141", dq_shapes),
            ("flash_bwd_dkv", "edgestyle_tpu_torch/kernels/flash_bwd.cu",
             "edgestyle_tpu/ops/flash.py:175", dkv_shapes)]


def sdpa_backward_ms(q, k, v, do, readings: int = 5) -> float:
    """One backward of F.scaled_dot_product_attention (dq, dk and dv
    together) on the same inputs, the library yardstick of both backward
    kernels: the median of `readings` timings. torch.autograd.grad returns
    the gradients without adding them into .grad, and each timing's calls
    queue behind a sleep of about 50 ms, which outlasts the host's autograd
    work for all of them."""
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl)

    def backward():
        torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)

    return statistics.median(time_ms(backward, sleep_cycles=100_000_000)
                             for _ in range(readings))


def bf16_order(a: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in value order: neighbours differ by 1."""
    i = a.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def activation_check(dev, gen, dtype) -> None:
    """The fused conv's bf16 activations against bf16(exact silu) of x in
    dtype: with an identity centre-tap weight and zero bias, each output is
    one activation times 1 plus zeros, so the kernel writes its activation
    unchanged. Pre-activations ~N(-1, 2.7) reach the negative range where
    silu is a small difference."""
    from edgestyle_tpu_torch.ops import fused_conv

    b, c, h, w = 2, 320, 64, 64
    x = torch.randn((b, c, h, w), generator=gen, device=dev).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    s = 2.5 * (1.0 + 0.1 * torch.randn((b, c), generator=gen, device=dev))
    t = torch.randn((b, c), generator=gen, device=dev) - 1.0
    wt = torch.zeros((c, c, 3, 3), device=dev)
    wt[torch.arange(c), torch.arange(c), 1, 1] = 1.0
    wt = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    out = fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, torch.zeros(c, device=dev))
    a = (x.double() * s.double()[:, :, None, None] + t.double()[:, :, None, None]).float()
    a = a.double()
    ref = (a * torch.sigmoid(a)).to(torch.bfloat16)
    ulps = (bf16_order(out) - bf16_order(ref)).abs()
    share = (ulps > 0).double().mean().item()
    print(f"fused conv activations vs bf16(exact silu), {str(dtype)[6:]} x, {ulps.numel()} "
          f"values, "
          f"pre-activation in [{a.min().item():.2f}, {a.max().item():.2f}]: "
          f"share rounded otherwise {share:.3e} (tol {ACT_SHARE_TOL}), "
          f"max {ulps.max().item()} bf16 ulps (tol 1)", flush=True)
    if not (share <= ACT_SHARE_TOL and ulps.max().item() <= 1):
        fail(f"the fused conv's activations stray from bf16(silu) on {dtype} x")


# ------------------------------------------------------------- generation
def build_pipeline(dev):
    """Full-width bf16 SD1.5 6-branch pipeline from the port's random init,
    with the zero-init ControlNet heads and cond-embedding conv_out set to
    small random values so every branch (and both kernels in its trunk)
    moves the image."""
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

    pipe = EdgeStylePipeline(PipelineConfig(), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = pipe.init_params(gen)

    def small(tree, std_scale):
        w = tree["kernel"]
        fan_in = math.prod(w.shape[1:])
        kernel = torch.randn(w.shape, generator=gen, device=dev) * (std_scale / math.sqrt(fan_in))
        return {"kernel": kernel.to(w.dtype).contiguous(memory_format=torch.channels_last),
                "bias": torch.zeros_like(tree["bias"])}

    for key in ("static", "lora_0", "lora_1"):
        tree = params["controlnet"][key]
        for name in [k for k in tree if k.startswith("controlnet_down_blocks_")
                     or k == "controlnet_mid_block"]:
            tree[name] = small(tree[name], 0.3)
    emb = params["controlnet"]["static"]["controlnet_cond_embedding"]
    emb["conv_out"] = small(emb["conv_out"], 1.0)
    return pipe, params, gen


def make_request(gen, dev, b: int, n_branches: int, latent_branches):
    ids = torch.randint(1, 49407, (b, 77), generator=gen, device=dev)
    neg = torch.randint(1, 49407, (b, 77), generator=gen, device=dev)
    imgs = []
    for p in range(n_branches):
        im = torch.rand((b, 3, 512, 512), generator=gen, device=dev)
        imgs.append(im * 2 - 1 if p in latent_branches else im)  # VAE branches take [-1, 1]
    lat = torch.randn((b, 4, 64, 64), generator=gen, device=dev)
    return ids, neg, imgs, lat


def check_images(out, b: int, what: str) -> None:
    if tuple(out.shape) != (b, 3, 512, 512):
        fail(f"{what}: image shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite image values")
    lo, hi, std = out.min().item(), out.max().item(), out.float().std().item()
    if lo < 0 or hi > 1 or not std > 0:
        fail(f"{what}: image range [{lo}, {hi}] std {std}")


# Launches per generation (any batch), from the code at SD1.5 width, 512 px,
# 20 steps: flash_fwd at the 22 self-attentions with >= 1024 tokens per
# denoise step (the UNet's 10, 4 in each of the 3 trunks); one GN statistics
# and one conv launch per fused conv: 104 a step (2 per ResNet block: the
# UNet's 22 and each trunk's 10), plus the VAE's 48 (encoder 10 blocks for
# the three VAE conds in one batch, decoder 14).
GEN_STEPS = 20
GEN_LAUNCHES_PER_REQUEST = {"flash_fwd": 22 * GEN_STEPS,
                            "gn_scale_shift": 104 * GEN_STEPS + 2 * (10 + 14),
                            "fused_gn_silu_conv3x3": 104 * GEN_STEPS + 2 * (10 + 14),
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def generation_phase(dev, pipe, params, gen):
    from edgestyle_tpu_torch import kernels

    cfg = pipe.cfg
    # warm-up (lazy library loads, cuBLAS/cuDNN plans): not a counted request
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    t0 = time.perf_counter()
    out = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=2)
    torch.cuda.synchronize()
    print(f"warm-up request (B=1, 2 steps): {time.perf_counter() - t0:.3f} s", flush=True)

    requests = [
        ("B=1 guidance 3.5", 1, 3.5),
        ("B=2 per-sample guidance [3.5, 7.5]", 2, [3.5, 7.5]),
        ("B=1 guidance 5.0", 1, 5.0),
    ]
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for what, b, g in requests:
        ids, neg, imgs, lat = make_request(gen, dev, b, cfg.num_branches, cfg.latent_branches)
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=GEN_STEPS,
                   guidance_scale=g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_images(out, b, what)
        per = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        print(f"request {what}, {GEN_STEPS} UniPC steps, 512 px: {dt:.3f} s, {b / dt:.4f} "
              f"images/s, image mean {out.mean().item():.4f} std {out.std().item():.4f}, "
              f"launches per generation {per}", flush=True)
        if per != GEN_LAUNCHES_PER_REQUEST:
            fail(f"the generation's kernel launches differ from the counts the code predicts "
                 f"{GEN_LAUNCHES_PER_REQUEST}")
    totals = dict(kernels.LAUNCHES)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return totals


def profile_phase(dev, pipe, params, gen, out_dir: str) -> None:
    """One B=1 20-step generation under torch.profiler: device time by
    kernel and the device's busy share of the wall time. The full table
    goes to ``out_dir/profile_b1.txt``."""
    from torch.profiler import ProfilerActivity, profile

    cfg = pipe.cfg
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_b1.txt"), "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy:.4f} s\n")
        for ms, n, key in rows:
            f.write(f"{ms:12.3f} ms {n:7d}x  {key}\n")
    print(f"profile (B=1, 20 steps, profiler on): wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), idle share {100 * (1 - busy / wall):.1f}%, "
          f"{sum(r[1] for r in rows)} device launches", flush=True)
    _print_families(rows, busy)
    for ms, n, key in rows[:12]:
        print(f"  {ms:10.3f} ms {100 * ms / 1e3 / busy:5.1f}% {n:6d}x {key[:90]}", flush=True)


def e2e_phase(dev, pipe, params, gen):
    """2 steps through the kernels, then through the ops' plain versions
    (the layers' and attention's references swapped in here, not by any
    switch in the port), on the same weights, inputs and latents."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.models import layers
    from edgestyle_tpu_torch.ops import attention, flash, fused_conv

    cfg = pipe.cfg
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    out_k = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=2)
    saved = (layers.norm_act_conv3x3, attention.flash_attention)
    layers.norm_act_conv3x3 = fused_conv.norm_act_conv3x3_reference
    attention.flash_attention = flash.flash_attention_reference
    try:
        before = dict(kernels.LAUNCHES)
        out_p = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=2)
        torch.cuda.synchronize()
        if kernels.LAUNCHES != before:
            fail("the plain run launched a kernel")
    finally:
        layers.norm_act_conv3x3, attention.flash_attention = saved
    check_images(out_k, 1, "e2e kernels")
    check_images(out_p, 1, "e2e plain")
    diff = (out_k - out_p).abs()
    print(f"e2e kernels vs plain (2 steps, bf16): image max_abs_diff={diff.max().item():.4e} "
          f"mean_abs_diff={diff.mean().item():.4e} (tol {E2E_TOL})", flush=True)
    if not diff.max().item() <= E2E_TOL:
        fail("end-to-end images through the kernels and the plain versions disagree")


# ---------------------------------------------------------------- training
TRAIN_STEPS = 3
TRAIN_ARGV = ["--random_init", "--resolution", "512", "--train_batch_size", "2",
              "--gradient_accumulation_steps", "1", "--max_train_steps", str(TRAIN_STEPS),
              "--mixed_precision", "bf16", "--logging_steps", "1", "--seed", "0"]
# Launches per micro-step, from the code at SD1.5 width and 512 px:
#   flash_fwd: every self-attention with >= 1024 tokens: the UNet's 10 (down
#     blocks 0-1, up blocks 2-3) and 4 in each of the 3 ControlNet trunks;
#   fused conv, and the GN statistics before each: 2 per ResNet block: the
#     VAE encoder's 10 (run twice: the image, then the three VAE conds), the
#     UNet's 22, each trunk's 10;
#   flash_bwd_*: only attentions whose output needs a gradient: the UNet's
#     up-block self-attentions (6; its down path sees no trainable) and the
#     two LoRA trunks' 4 each (the static trunk is frozen and has no
#     trainable upstream).
TRAIN_LAUNCHES_PER_STEP = {"flash_fwd": 10 + 3 * 4,
                           "gn_scale_shift": 2 * (2 * 10 + 22 + 3 * 10),
                           "fused_gn_silu_conv3x3": 2 * (2 * 10 + 22 + 3 * 10),
                           "flash_bwd_dq": 6 + 2 * 4, "flash_bwd_dkv": 6 + 2 * 4}


def train_out_dir() -> str:
    """Checkpoints of the training phase, inside the checkout (git-ignored)."""
    return os.path.join(HERE, "build", "torch_ext", "chip_smoke_train")


def training_phase(dev):
    """The trainer's entry point at full width for TRAIN_STEPS steps, with
    the launch counts and the peak memory read around it alone. Returns
    (launches, (pipe, frozen, tcfg, initial state)): the initial state is
    rebuilt afterwards from the same seed by the same ``build`` that
    ``main`` calls, to show what moved."""
    import shutil

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.training import checkpoint
    from edgestyle_tpu_torch.training.train_step import TRAINABLE_GROUPS

    out_dir = train_out_dir()
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = TRAIN_ARGV + ["--output_dir", out_dir]
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    log = res["log"]
    if [r["step"] for r in log] != list(range(1, TRAIN_STEPS + 1)):
        fail(f"training logged steps {[r['step'] for r in log]}")
    losses, ds = [r["loss"] for r in log], [r["d"] for r in log]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss {losses}")
    if not all(b >= a for a, b in zip(ds, ds[1:])):
        fail(f"Prodigy's d fell: {ds}")
    ends = [0.0] + [r["elapsed_s"] for r in log]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    steady = sum(step_s[1:]) / len(step_s[1:])
    b = 2
    print(f"training ({TRAIN_STEPS} steps, micro-batch {b}, 512 px, Prodigy, snr_gamma 5): "
          f"losses {losses}, d {ds}; seconds per step {[round(x, 4) for x in step_s]} "
          f"(first includes warm-up); steady {steady:.4f} s/step, {steady / b:.4f} s/sample; "
          f"main() wall {wall:.2f} s (build and checkpoint included); peak device memory of "
          f"main() alone {peak:.2f} GiB", flush=True)

    t0 = time.perf_counter()
    built = train.build(train.parse_args(argv), dev)
    torch.cuda.synchronize()
    print(f"trainer build again for the checks (full-width SD1.5, frozen bf16, trainables "
          f"fp32): {time.perf_counter() - t0:.2f} s", flush=True)
    pipe, frozen0, tcfg, state0, _ = built
    init = flatten(state0["trainable"])
    final = flatten(res["state"]["trainable"])
    for group in TRAINABLE_GROUPS:
        keys = [k for k in init if k[0] == group]
        moved = [k for k in keys if not torch.equal(final[k], init[k])]
        delta = max((final[k] - init[k]).abs().max().item() for k in keys)
        print(f"  {group}: {len(moved)} of {len(keys)} leaves moved, max |change| "
              f"{delta:.3e}", flush=True)
        if not moved:
            fail(f"trainable group {group} did not move")
    frozen = flatten(res["frozen"])
    if frozen.keys() != flatten(frozen0).keys() or not all(
            torch.equal(frozen[k], v) for k, v in flatten(frozen0).items()):
        fail("a frozen weight changed in training")
    back = checkpoint.load_checkpoint(out_dir, device=dev)
    if back["step"] != TRAIN_STEPS or not checkpoint.states_equal(back, res["state"]):
        fail("the final checkpoint does not read back equal to the trained state")
    print(f"  frozen weights unchanged ({len(frozen)} leaves); checkpoint-{back['step']} read "
          f"back equal", flush=True)

    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"training launches per step {per_step}, predicted {TRAIN_LAUNCHES_PER_STEP}",
          flush=True)
    if per_step != TRAIN_LAUNCHES_PER_STEP:
        fail("the training step's kernel launches differ from the counts the code predicts")
    del res, back, frozen, final
    return launches, (pipe, frozen0, tcfg, state0)


def fp32_training_phase(dev) -> None:
    """One step of the trainer's entry point with ``--mixed_precision no``
    at micro-batch 1: an fp32 model on the card runs its long attentions
    through the flash kernels (q, k, v and dO rounded to bf16 on the way
    in), so the step launches the flash kernels as a bf16 step does, and
    takes the conv's plain version (the conv kernel multiplies bf16 weights
    only, as the reference sends non-bf16 convs to XLA), so it launches no
    GN statistics or conv kernel. Its loss must be finite and its weights
    fp32."""
    import shutil

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core.params import flatten

    out_dir = train_out_dir() + "_fp32"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = TRAIN_ARGV + ["--mixed_precision", "no", "--train_batch_size", "1",
                         "--max_train_steps", "1", "--output_dir", out_dir]
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [r["loss"] for r in res["log"]]
    dtypes = {v.dtype for tree in (res["frozen"], res["state"]["trainable"])
              for v in flatten(tree).values() if v.is_floating_point()}
    print(f"fp32 training (--mixed_precision no, 1 step, micro-batch 1, 512 px): losses "
          f"{losses}; weight dtypes {sorted(map(str, dtypes))}; kernel launches {launches}; "
          f"main() wall {wall:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses):
        fail(f"the fp32 training step's loss is not one finite value: {losses}")
    if dtypes != {torch.float32}:
        fail(f"the fp32 model holds weights of other types: {dtypes}")
    predicted = {k: v if k.startswith("flash") else 0
                 for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    print(f"  fp32 launches predicted {predicted}", flush=True)
    if launches != predicted:
        fail("the fp32 training step's kernel launches differ from the counts the code "
             "predicts")
    del res


def _live_trainables(state, gen):
    """A copy of the trainables with the zero-init ControlNet heads and LoRA
    ups given small random values, so that every trunk gradient is live."""
    from edgestyle_tpu_torch.core.params import flatten, unflatten

    out = {}
    for k, v in flatten(state["trainable"]).items():
        if (k[0].startswith("heads") and k[-1] == "kernel") or k[-1] == "up":
            fan_in = math.prod(v.shape[1:])
            v = torch.randn(v.shape, generator=gen, device=v.device) * (0.3 / math.sqrt(fan_in))
        out[k] = v.clone()
    return unflatten(out)


def _grad_diffs(g, g_p, groups):
    """Relative L2 difference of g from g_p per trainable group, and the
    worst single leaf's (key, relative L2 difference, |g_p leaf|_2)."""
    rel = lambda diff, norm: diff / norm if norm > 0 else (0.0 if diff == 0 else math.inf)  # noqa: E731
    per_group, worst = {}, (None, 0.0, 0.0)
    for group in groups:
        diff2 = norm2 = 0.0
        for k in (k for k in g_p if k[0] == group):
            d2 = (g[k].float() - g_p[k].float()).square().sum().item()
            n2 = g_p[k].float().square().sum().item()
            diff2, norm2 = diff2 + d2, norm2 + n2
            if rel(math.sqrt(d2), math.sqrt(n2)) > worst[1]:
                worst = (k, rel(math.sqrt(d2), math.sqrt(n2)), math.sqrt(n2))
        per_group[group] = (rel(math.sqrt(diff2), math.sqrt(norm2)), math.sqrt(norm2))
    return per_group, worst


def grad_check_phase(dev, built):
    """One micro-batch (B=1) through the kernels, then through the ops'
    plain versions (swapped in here, as e2e_phase swaps them), same weights
    and draws: the loss and each trainable group's gradients. Then once more
    through the kernels for each planted fault (dq set to 0, dv set to 0),
    which the check must reject."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core.params import flatten, unflatten
    from edgestyle_tpu_torch.models import layers
    from edgestyle_tpu_torch.ops import attention, flash, fused_conv
    from edgestyle_tpu_torch.training import train_step
    from edgestyle_tpu_torch.training.train_step import TRAINABLE_GROUPS

    pipe, frozen, tcfg, state = built
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    trainable = _live_trainables(state, gen)
    args = train.parse_args(TRAIN_ARGV + ["--train_batch_size", "1"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.synthetic_loader(args)).items()}
    draws = train_step.sample_draws(pipe, tcfg, batch, gen)[0]
    mb = {k: v[0] for k, v in batch.items()}
    sched = train_step.SCHEDULE.to(dev)

    def loss_and_grads():
        leaves = {k: v.detach().requires_grad_(True) for k, v in flatten(trainable).items()}
        loss = train_step.controlnet_loss_fn(unflatten(leaves), frozen, pipe, sched, tcfg, mb,
                                             draws)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, grads))

    kernels.reset_launches()
    loss_k, g_k = loss_and_grads()
    launched = dict(kernels.LAUNCHES)
    if not all(launched.values()):
        fail(f"the kernel run of the gradient check missed a kernel: {launched}")
    saved = (layers.norm_act_conv3x3, attention.flash_attention)
    layers.norm_act_conv3x3 = fused_conv.norm_act_conv3x3_reference
    attention.flash_attention = flash.flash_attention_reference
    try:
        kernels.reset_launches()
        loss_p, g_p = loss_and_grads()
        torch.cuda.synchronize()
        if any(kernels.LAUNCHES.values()):
            fail("the plain run of the gradient check launched a kernel")
    finally:
        layers.norm_act_conv3x3, attention.flash_attention = saved
    # planted faults: a backward kernel's wrapper with one gradient zeroed
    dq_kernel, dkv_kernel = flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda

    def dv_zero(*a):
        dk, dv = dkv_kernel(*a)
        return dk, dv.zero_()

    faults = {"planted fault dq = 0": ("flash_bwd_dq_cuda", lambda *a: dq_kernel(*a).zero_()),
              "planted fault dv = 0": ("flash_bwd_dkv_cuda", dv_zero)}
    g_faults = {}
    for what, (name, faulty) in faults.items():
        saved = getattr(flash, name)
        setattr(flash, name, faulty)
        try:
            g_faults[what] = loss_and_grads()[1]
        finally:
            setattr(flash, name, saved)
    kernels.reset_launches()
    print(f"gradient check (B=1, one micro-batch, bf16): loss through the kernels "
          f"{loss_k:.6f}, through the plain versions {loss_p:.6f}; kernel launches {launched}",
          flush=True)
    ok = {}
    for what, g in (("kernels", g_k), *g_faults.items()):
        per_group, (key, leaf_rel, leaf_norm) = _grad_diffs(g, g_p, TRAINABLE_GROUPS)
        print(f"  {what} vs plain: relative L2 difference per group (tol {GRAD_TOL}) "
              + ", ".join(f"{grp} {r:.3e} (|g_plain|_2 {n:.3e})"
                          for grp, (r, n) in per_group.items())
              + f"; worst leaf {'/'.join(map(str, key)) if key else '-'} {leaf_rel:.3e} "
              f"(tol {LEAF_TOL}; |g_plain|_2 {leaf_norm:.3e})", flush=True)
        ok[what] = all(r <= GRAD_TOL for r, _ in per_group.values()) and leaf_rel <= LEAF_TOL
    if not ok["kernels"]:
        fail("trainable gradients through the kernels and the plain versions disagree")
    for what in g_faults:
        if ok[what]:
            fail(f"the gradient check passed a {what}")


def profile_train_step(dev, built, out_dir: str) -> None:
    """One training step (micro-batch 2) under torch.profiler: device time
    by kernel family; the table goes to ``out_dir/profile_train.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.training import train_step

    pipe, frozen, tcfg, state = built
    args = train.parse_args(TRAIN_ARGV)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.synthetic_loader(args)).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    step = train_step.make_train_step(pipe, tcfg)
    step(state, frozen, batch, train_step.sample_draws(pipe, tcfg, batch, gen))  # warm-up
    draws = train_step.sample_draws(pipe, tcfg, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, frozen, batch, draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_train.txt"), "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy:.4f} s\n")
        for ms, n, key in rows:
            f.write(f"{ms:12.3f} ms {n:7d}x  {key}\n")
    print(f"profile (one training step, micro-batch 2, profiler on): wall {wall:.3f} s, device "
          f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), {sum(r[1] for r in rows)} device "
          f"launches", flush=True)
    _print_families(rows, busy)


def _print_families(rows, busy: float) -> None:
    """Device time and launches by kernel family."""
    families = {}
    for ms, n, key in rows:
        fam = _family(key)
        t, c = families.get(fam, (0.0, 0))
        families[fam] = (t + ms, c + n)
    for fam, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam}: {ms:.3f} ms {100 * ms / 1e3 / busy:5.1f}% {n}x", flush=True)


def _device_rows(prof):
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def _family(key: str) -> str:
    """A device kernel's family, by its name."""
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_fwd_kernel"):
        if name in key:
            return name
    if ("fused_gn_silu_conv3x3" in key or "split_sum_kernel" in key
            or "gn_stats_kernel" in key):
        return "fused conv (gn_stats.cu + fused_conv.cu)"
    low = key.lower()
    if "conv" in low or "cudnn" in low or "dgrad" in low or "wgrad" in low:
        return "cuDNN convolutions (conv backward, 1x1 and strided convs)"
    if "gemm" in low or "cutlass" in low or "xmma" in low or "cublas" in low:
        return "cuBLAS / CUTLASS GEMMs"
    return "PyTorch elementwise, reductions and copies"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile one B=1 generation; write the table under DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py needs one GPU",
              flush=True)
        return 2
    try:
        from edgestyle_tpu_torch import kernels
    except ImportError as e:
        print(f"FAIL: the port package is not beside chip_smoke.py ({e})", flush=True)
        return 2
    if not os.path.abspath(kernels.__file__).startswith(os.path.join(HERE, "")):
        print(f"FAIL: imported the port from {kernels.__file__}, not from beside "
              f"chip_smoke.py", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.library, kernels.SOURCES))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name in kernels.SOURCES:
        log = kernels.build_log(name)
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    records = kernel_phase(dev)
    t0 = time.perf_counter()
    pipe, params, gen = build_pipeline(dev)
    torch.cuda.synchronize()
    print(f"pipeline init (full-width SD1.5, bf16): {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches = generation_phase(dev, pipe, params, gen)
    if args.profile:
        profile_phase(dev, pipe, params, gen, args.profile)
    e2e_phase(dev, pipe, params, gen)
    del pipe, params
    torch.cuda.empty_cache()

    train_launches, built = training_phase(dev)
    grad_check_phase(dev, built)
    if args.profile:
        profile_train_step(dev, built, args.profile)
    del built
    fp32_training_phase(dev)

    # each kernel's path: the generation for the forward kernels, training
    # for the backward ones (which generation never runs)
    paths = {"flash_fwd": "generation", "gn_scale_shift": "generation",
             "fused_gn_silu_conv3x3": "generation", "flash_bwd_dq": "training",
             "flash_bwd_dkv": "training"}
    by_path = {"generation": launches, "training": train_launches}
    out = []
    for name, source, replaces, shapes in records:
        # the record's bound is the largest shape's; exponentials are
        # operations too (on the SFU), and each shape names its own bound
        top_by = max(shapes, key=lambda s: s["bound_ms"])["bound_by"]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=by_path[paths[name]][name],
            launches_by_path={p: counts[name] for p, counts in by_path.items()},
            max_abs_err=max(s["max_abs_err"] for s in shapes),
            ms=sum(s["ms"] for s in shapes),
            plain_ms=sum(s["plain_ms"] for s in shapes),
            bound_ms=sum(s["bound_ms"] for s in shapes),
            bound_by=top_by if top_by != "exp" else "operations",
            library_ms=sum(s["library_ms"] for s in shapes),
            shapes=shapes,
        ))
        if by_path[paths[name]][name] == 0:
            fail(f"kernel {name} was never launched on its path ({paths[name]})")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

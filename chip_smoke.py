"""Chip smoke test of the PyTorch/CUDA port (edgestyle_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --profile OUT_DIR  # + a profiled B=1 generation

Phases, each of which ends the run with a non-zero exit on failure:

  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. kernel phase: every hand-written kernel against its plain PyTorch
     version on the card, at the full-width shapes the main path gives it,
     with its time, the plain version's time, one PyTorch library call of
     the same function as a yardstick (never used by the port) and the
     least time the card could take (the bound); and the fused conv's bf16
     activations against bf16(exact silu);
  3. generation phase: the full-width SD1.5 6-branch try-on
     (``EdgeStylePipeline.__call__``, 512 px, 20 UniPC steps, bf16) from the
     port's random init, for a few requests, with the kernels' launch counts
     read around the requests;
  4. end-to-end check: the same generation at 2 steps through the kernels
     and through the ops' plain versions, image max-abs difference under a
     stated bf16 tolerance.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``{"kernels": [...]}`` record.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
PEAK_BYTES = 3.35e12

# Kernel against plain version: max-abs error <= REL_TOL * max|plain output|,
# i.e. 2 to 4 bf16 ulps (8 significant bits) of the largest output. Set from
# the output's own scale: a softmax mix of N random v is ~N(0, e/N), far
# below |v|, so an absolute limit would pass a P*V that is off by a large
# share of its output.
REL_TOL = 2.0 ** -6
LSE_TOL = 1e-2     # fp32 row logsumexp of values ~log(N) + 0.5
# The conv's bf16 activations against exact silu: a fast-math silu a few
# fp32 ulps from exact moves a bf16 rounding for ~2^-13 of the values, and
# then by one ulp.
ACT_SHARE_TOL = 1e-3
E2E_TOL = 0.1      # [0,1] images after 2 bf16 steps through 3 ControlNets + UNet + VAE


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
FLASH_SHAPES = [(2 * 8, 4096, 40), (2 * 8, 1024, 80)]
CONV_SHAPES = [  # (B, Cin, H, W, Cout)
    (2, 320, 64, 64, 320),
    (2, 1920, 32, 32, 640),
    (2, 1280, 8, 8, 1280),
    (1, 128, 512, 512, 128),
]


def kernel_phase(dev):
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.ops import flash, fused_conv

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records = []

    shapes = []
    for bh, n, d in FLASH_SHAPES:
        q, k, v = (torch.randn((1, bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out, lse = flash.flash_attention_cuda(q, k, v, scale)
        torch.cuda.synchronize()
        ref = flash.flash_attention_reference(q, k, v, scale)
        ref_lse = flash.flash_attention_reference_lse(q, k, scale)
        err = (out.float() - ref.float()).abs().max().item()
        tol = REL_TOL * ref.float().abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v, scale))
        plain_ms = time_ms(lambda: flash.flash_attention_reference(q, k, v, scale), iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        b_ms, b_by = bound_ms(4.0 * bh * n * n * d, 4 * bh * n * d * 2 + bh * n * 4)
        print(f"flash_fwd BH={bh} N={n} D={d}: max_abs_err={err:.3e} (tol {tol:.3e}; "
              f"mean |ref| {ref.float().abs().mean().item():.3e}) lse_err={lse_err:.3e} "
              f"(tol {LSE_TOL}) ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not (err <= tol and lse_err <= LSE_TOL):
            fail(f"flash_fwd disagrees with its plain version at {(bh, n, d)}")
        shapes.append(dict(shape=[bh, n, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records.append(("flash_fwd", "edgestyle_tpu_torch/kernels/flash_fwd.cu",
                    "edgestyle_tpu/ops/flash.py:42", shapes))

    shapes = []
    for b, cin, h, w, cout in CONV_SHAPES:
        x = torch.randn((b, cin, h, w), generator=gen, device=dev).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        gamma = 1.0 + 0.1 * torch.randn((cin,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((cin,), generator=gen, device=dev)
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              / math.sqrt(9 * cin)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bias = 0.1 * torch.randn((cout,), generator=gen, device=dev)
        eps = 1e-6 if h == 512 else 1e-5
        s, t = fused_conv.gn_scale_shift(x, gamma, beta, 32, eps)
        out = fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, bias)
        torch.cuda.synchronize()
        ref = fused_conv.norm_act_conv3x3_reference(x, gamma, beta, wt, bias, 32, eps,
                                                    torch.bfloat16)
        err = (out.float() - ref.float()).abs().max().item()
        tol = REL_TOL * ref.float().abs().max().item()
        # ms: the kernel alone, on precomputed s, t; op_ms: the op the main
        # path calls (GN statistics + kernel), like for like with plain_ms
        ms = time_ms(lambda: fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, bias))
        op_ms = time_ms(lambda: fused_conv.norm_act_conv3x3(
            x, gamma, beta, wt, bias, num_groups=32, eps=eps, dtype=torch.bfloat16))
        plain_ms = time_ms(lambda: fused_conv.norm_act_conv3x3_reference(
            x, gamma, beta, wt, bias, 32, eps, torch.bfloat16))
        act = F.silu(x.float() * s[:, :, None, None] + t[:, :, None, None]).to(torch.bfloat16)
        act = act.contiguous(memory_format=torch.channels_last)
        bias_bf = bias.to(torch.bfloat16)
        lib_ms = time_ms(lambda: F.conv2d(act, wt, bias_bf, padding=1))
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = b * h * w * cin * 2 + 2 * b * cin * 4 + 9 * cin * cout * 2 + cout * 4 \
            + b * h * w * cout * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        print(f"fused_gn_silu_conv3x3 x=({b},{cin},{h},{w}) -> {cout}: max_abs_err={err:.3e} "
              f"(tol {tol:.3e}; mean |ref| {ref.float().abs().mean().item():.3e}) ms={ms:.4f} "
              f"op_ms={op_ms:.4f} plain_ms={plain_ms:.4f} conv2d_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not err <= tol:
            fail(f"fused conv disagrees with its plain version at {(b, cin, h, w, cout)}")
        shapes.append(dict(shape=[b, cin, h, w, cout], max_abs_err=err, ms=ms, op_ms=op_ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records.append(("fused_gn_silu_conv3x3", "edgestyle_tpu_torch/kernels/fused_conv.cu",
                    "edgestyle_tpu/ops/fused_conv.py:88", shapes))
    activation_check(dev, gen)
    # launches made for the comparison do not count
    kernels.reset_launches()
    return records


def bf16_order(a: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in value order: neighbours differ by 1."""
    i = a.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def activation_check(dev, gen) -> None:
    """The fused conv's bf16 activations against bf16(exact silu): with an
    identity centre-tap weight and zero bias, each output is one activation
    times 1 plus zeros, so the kernel writes its activation unchanged.
    Pre-activations ~N(-1, 2.7) reach the negative range where silu is a
    small difference."""
    from edgestyle_tpu_torch.ops import fused_conv

    b, c, h, w = 2, 320, 64, 64
    x = torch.randn((b, c, h, w), generator=gen, device=dev).to(torch.bfloat16)
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
    print(f"fused conv activations vs bf16(exact silu), {ulps.numel()} values, "
          f"pre-activation in [{a.min().item():.2f}, {a.max().item():.2f}]: "
          f"share rounded otherwise {share:.3e} (tol {ACT_SHARE_TOL}), "
          f"max {ulps.max().item()} bf16 ulps (tol 1)", flush=True)
    if not (share <= ACT_SHARE_TOL and ulps.max().item() <= 1):
        fail("the fused conv's activations stray from bf16(silu)")


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
        out = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=20,
                   guidance_scale=g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_images(out, b, what)
        per = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        print(f"request {what}, 20 UniPC steps, 512 px: {dt:.3f} s, {b / dt:.4f} images/s, "
              f"image mean {out.mean().item():.4f} std {out.std().item():.4f}, "
              f"launches per generation {per}", flush=True)
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
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_b1.txt"), "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy:.4f} s\n")
        for ms, n, key in rows:
            f.write(f"{ms:12.3f} ms {n:7d}x  {key}\n")
    print(f"profile (B=1, 20 steps, profiler on): wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), idle share {100 * (1 - busy / wall):.1f}%", flush=True)
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

    out = []
    for name, source, replaces, shapes in records:
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(s["max_abs_err"] for s in shapes),
            ms=sum(s["ms"] for s in shapes),
            plain_ms=sum(s["plain_ms"] for s in shapes),
            bound_ms=sum(s["bound_ms"] for s in shapes),
            bound_by=max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
            library_ms=sum(s["library_ms"] for s in shapes),
            shapes=shapes,
        ))
        if launches[name] == 0:
            fail(f"kernel {name} was never launched on the main path")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

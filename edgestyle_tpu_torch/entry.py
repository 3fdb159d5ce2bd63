"""The port's flagship forward step, for callers that run or capture one step.

Counterpart of ``__graft_entry__.entry()``: the full-size SD1.5 UNet and
EdgeStyle's 6-branch MultiControlNet denoise step in bf16, with weights
from the port's seeded init (``EdgeStylePipeline.init_params``, seed 0) and
zero example inputs at 512 px (64 x 64 latents). ``fn`` is the step that
``apps/export.py --what unet_controlnet`` exports, without the CFG
combine: B rows in, the UNet's noise prediction out. On the card its long
self-attentions and ResNet convs launch the port's kernels through their
``edgestyle::*`` operators (22 flash forward, 104 GN statistics and 104
fused conv launches a call).

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: the several-card paths at a tiny
configuration on CPU ranks (``gloo``).
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, make_generator, resolve_device
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig
from edgestyle_tpu_torch.models.unet import UNetConfig
from edgestyle_tpu_torch.models.vae import VAEConfig
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

# __graft_entry__.py's dryrun configuration
DRYRUN_TINY = PipelineConfig(
    unet=UNetConfig(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=24,
                    num_heads=2, cond_embedding_channels=(8, 16)),
    vae=VAEConfig(block_out_channels=(32, 64), layers_per_block=1, sample_size=32),
    clip=CLIPTextConfig(vocab_size=100, hidden_size=24, num_layers=2, num_heads=2,
                        max_positions=7, intermediate_size=32),
    dtype="float32")


def entry(device: DeviceLike = "cuda"):
    """Returns ``(fn, (params, latents, t, ctx, embs))``."""
    dev = resolve_device(device)
    pipe = EdgeStylePipeline(PipelineConfig(), device=dev)
    params = pipe.init_params(make_generator(0, dev))
    scales = np.ones((pipe.cfg.num_branches,), np.float32)

    def fn(params, latents, t, ctx, embs):
        down, mid = pipe.mcn(params["controlnet"], latents, t, ctx, embs, scales)
        return pipe.unet(params["unet"], latents, t, ctx, down_block_additional_residuals=down,
                         mid_block_additional_residual=mid)

    b, hw = 1, 64
    cl = torch.channels_last
    lat = torch.zeros((b, 4, hw, hw), device=dev).contiguous(memory_format=cl)
    t = torch.zeros((b,), dtype=torch.long, device=dev)
    ctx = torch.zeros((b, 77, 768), device=dev)
    emb = torch.zeros((b, 320, hw, hw), device=dev).contiguous(memory_format=cl)
    return fn, (params, lat, t, ctx, [emb] * pipe.cfg.num_branches)


def dryrun_multichip(n_devices: int) -> list:
    """The several-card paths on ``n_devices`` CPU ranks (``gloo``), at
    ``__graft_entry__.py``'s tiny configuration: the data-parallel train
    step (grad_accum 2, one sample per rank), the data-parallel distill
    step, ``generate_dp`` (B = n), then on the (n/2, 2) mesh the
    tensor-parallel UNet forward, the DP x TP train step, the sharded
    checkpoint's save and resume of its state (bit for bit on every rank)
    and ``generate_tp``. Rank 0 prints one line a stage; returns those
    lines."""
    from edgestyle_tpu_torch.core.mesh import run_ranks

    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as ckpt_root:
        return run_ranks(_dryrun_rank, n_devices, (n_devices, ckpt_root))[0]


def _dryrun_rank(n: int, ckpt_root: str) -> list:
    from edgestyle_tpu_torch.core import mesh as M
    from edgestyle_tpu_torch.core.partitioning import shard_params_tp, shard_pipeline_frozen_tp
    from edgestyle_tpu_torch.ops import tp
    from edgestyle_tpu_torch.training.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint,
        states_equal,
    )
    from edgestyle_tpu_torch.training.distill import (
        DistillConfig,
        init_distill_state,
        make_distill_step,
        sample_distill_draws,
    )
    from edgestyle_tpu_torch.training.train_step import (
        TrainConfig,
        init_trainable,
        local_draws,
        make_optimizer,
        make_train_step,
        sample_draws,
    )

    dev = M.init_distributed("cpu")
    mesh = M.make_mesh(M.MeshSpec(data=n), dev)
    group = mesh.get_group(M.DATA_AXIS)
    lines = []

    def say(msg):
        if M.is_rank0():
            lines.append(f"dryrun_multichip({n}): {msg}")
            print(lines[-1], flush=True)

    pipe = EdgeStylePipeline(DRYRUN_TINY, device=dev)
    params = M.replicate_params(mesh, pipe.init_params(make_generator(0, dev)))
    frozen = {"vae": params["vae"], "clip": params["clip"], "unet": params["unet"],
              "static": params["controlnet"]["static"]}
    cfg = TrainConfig(grad_accum=2)
    trainable = init_trainable(pipe, make_generator(1, dev), params["unet"], lora_rank=4)
    state0 = {"trainable": trainable, "opt_state": make_optimizer(cfg).init(trainable), "step": 0}

    g = np.random.default_rng(0)
    accum, mb = cfg.grad_accum, n  # one sample per rank

    def img():
        return g.standard_normal((accum, mb, 3, 32, 32)).astype(np.float32) * 0.2

    host = {"original": img(), "agnostic": img(), "head": img(), "clothes": img(),
            "clothes2": img(), "original_openpose": img(), "clothes_openpose": img(),
            "clothes_openpose2": img(), "input_ids": g.integers(1, 99, (accum, mb, 7))}

    def local(host_batch, draws, on=mesh):
        b = host_batch["original"].shape[1]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 M.shard_batch(on, host_batch, axis=1).items()}
        return batch, local_draws(draws, M.rows(on, b), b)

    global_draws = sample_draws(pipe, cfg, host, make_generator(7, dev))
    batch, draws = local(host, global_draws)
    state, metrics = make_train_step(pipe, cfg, data_group=group)(state0, frozen, batch, draws)
    if not torch.isfinite(metrics["loss"]):
        raise RuntimeError(f"DP train step: loss {metrics['loss']}")
    say(f"DP train step ok -- loss={float(metrics['loss']):.4f}, "
        f"d={float(metrics['d']):.2e}, step={state['step']}")

    dcfg = DistillConfig(lora_rank=4, grad_accum=1)
    dstate = init_distill_state(pipe, make_generator(3, dev), params["unet"], dcfg)
    dfrozen = dict(frozen, controlnet=params["controlnet"])
    with torch.no_grad():
        uncond = pipe.clip(params["clip"], torch.zeros((1, 7), dtype=torch.long,
                                                       device=dev))["last_hidden_state"]
    dhost = {k: v[:1] for k, v in host.items()}
    dbatch, ddraws = local(dhost, sample_distill_draws(pipe, dcfg, dhost, make_generator(9, dev)))
    dstate, dmetrics = make_distill_step(pipe, dcfg, data_group=group)(
        dstate, dfrozen, dbatch, uncond, ddraws)
    if not torch.isfinite(dmetrics["loss"]):
        raise RuntimeError(f"DP distill step: loss {dmetrics['loss']}")
    say(f"DP distill step ok -- loss={float(dmetrics['loss']):.4f}")

    gen_rng = np.random.default_rng(1)
    b = n
    ids = torch.from_numpy(gen_rng.integers(1, 99, (b, 7)))
    neg = torch.from_numpy(gen_rng.integers(1, 99, (b, 7)))
    imgs = [torch.from_numpy(gen_rng.standard_normal((b, 3, 32, 32)).astype(np.float32) * 0.1)
            for _ in range(6)]
    out = pipe.generate_dp(mesh, params, ids, neg, imgs, generator=make_generator(2, dev),
                           num_inference_steps=2)
    if out.shape != (b, 3, 32, 32) or not torch.isfinite(out).all():
        raise RuntimeError(f"generate_dp: {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
    say(f"DP batched generate ok -- B={b} over {M.axis_size(mesh, M.DATA_AXIS)} ranks")

    if n >= 2:
        mesh2 = M.make_mesh(M.MeshSpec(data=n // 2, model=2), dev)
        hw = DRYRUN_TINY.vae.sample_size // pipe.vae_downscale
        x = torch.zeros((n, 4, hw, hw)).contiguous(memory_format=torch.channels_last)
        t = torch.zeros((n,), dtype=torch.long)
        ctx = torch.zeros((n, 7, 24))
        unet = shard_params_tp(mesh2, params["unet"], num_heads=DRYRUN_TINY.unet.num_heads)
        with torch.no_grad(), tp.model_parallel(mesh2.get_group(M.MODEL_AXIS)):
            y = pipe.unet(unet, *(M.shard_batch(mesh2, a) for a in (x, t, ctx)))
        if not torch.isfinite(y).all():
            raise RuntimeError("TP UNet forward: not finite")
        say(f"TP(data={n // 2}, model=2) UNet forward ok")

        heads = {"vae": 1, "clip": DRYRUN_TINY.clip.num_heads,
                 "unet": DRYRUN_TINY.unet.num_heads, "static": DRYRUN_TINY.unet.num_heads}
        frozen_tp = shard_pipeline_frozen_tp(mesh2, frozen, heads)
        step2 = make_train_step(pipe, cfg, model_group=mesh2.get_group(M.MODEL_AXIS))
        batch2, draws2 = local(host, global_draws, mesh2)
        state2, metrics2 = step2(state0, frozen_tp, batch2, draws2)
        if not torch.isfinite(metrics2["loss"]):
            raise RuntimeError(f"DPxTP train step: loss {metrics2['loss']}")
        say(f"DPxTP(data={n // 2}, model=2) train step ok -- loss={float(metrics2['loss']):.4f}")

        save_checkpoint(ckpt_root, state2)
        restored = load_checkpoint_sharded(ckpt_root, state2, mesh2)
        if not states_equal(restored, state2):
            raise RuntimeError("sharded checkpoint: the resumed state differs")
        say(f"sharded checkpoint save/restore ok -- bit-identical resume into the "
            f"DPxTP(data={n // 2}, model=2) layout on every rank")
        out2 = pipe.generate_tp(mesh2, params, ids, neg, imgs, generator=make_generator(2, dev),
                                num_inference_steps=2)
        if out2.shape != (b, 3, 32, 32) or not torch.isfinite(out2).all():
            raise RuntimeError("generate_tp: wrong shape or not finite")
        say(f"DPxTP(data={n // 2}, model=2) generate ok -- B={b} over {n} ranks")
    return lines

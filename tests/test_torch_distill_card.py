"""The distiller's kernel path on the card (marked ``gpu``; skipped without a
card): every projection of the UNet carries an LCM-LoRA adapter merged into
its fp32 kernel (cast to bf16 at use), so the student's backward runs the
flash backward kernels on every long self-attention, down blocks included.
One consistency micro-batch at a narrow 512 px configuration whose UNet
attends over 1024 tokens, once through the kernels and once through the
ops' plain versions.
The file imports nothing of JAX or of the JAX package, so it runs where
only the port's dependencies are installed.
"""

import dataclasses
import math

import pytest
import torch

from edgestyle_tpu_torch import kernels
from edgestyle_tpu_torch.apps.distill import is_conv_kernel
from edgestyle_tpu_torch.apps.train import bf16_leaves
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.models import layers
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig
from edgestyle_tpu_torch.models.unet import UNetConfig
from edgestyle_tpu_torch.models.vae import VAEConfig
from edgestyle_tpu_torch.ops import attention, flash, fused_conv
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig
from edgestyle_tpu_torch.training import distill

# SD1.5's first two widths (320 and 640 channels, heads of 40, ten channels a
# GroupNorm group) at one ResNet a block, the TINY CLIP; a five-level VAE and
# cond embedding take 512 px images to 32 x 32 latents (1024 tokens at the
# first level: the flash kernels' rule).
CFG = PipelineConfig(
    unet=UNetConfig(block_out_channels=(320, 640), layers_per_block=1, cross_attention_dim=24,
                    num_heads=8, cond_embedding_channels=(16, 32, 64, 128, 256)),
    vae=VAEConfig(block_out_channels=(32,) * 5, layers_per_block=1, sample_size=512),
    clip=CLIPTextConfig(vocab_size=100, hidden_size=24, num_layers=2, num_heads=2,
                        max_positions=7, intermediate_size=32),
    dtype="bfloat16")
GROUPS = ("down_blocks", "mid_block", "up_blocks", "time_embedding")
# chip_smoke.py's bound on the trainable groups' gradients through the
# kernels against the plain versions, bf16 (GRAD_TOL)
GRAD_TOL = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _group(path) -> str:
    return next(g for g in GROUPS if path[0].startswith(g))


@pytest.mark.gpu
def test_distill_grads_through_the_kernels_match_the_plain_versions(cuda, monkeypatch):
    """Rank-8 adapters with live ups (N(0, 0.02^2)), B = 1, the distiller's
    frozen weights (apps/distill.py::build: fp32, the conv kernels bf16):
    each adapter group's gradient within GRAD_TOL (relative L2) of the
    plain versions'; the kernel run launches all five kernels, the plain
    run none."""
    pipe = EdgeStylePipeline(CFG, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = bf16_leaves(EdgeStylePipeline(dataclasses.replace(CFG, dtype="float32"),
                                           device=cuda).init_params(gen), is_conv_kernel)
    frozen = {"vae": params["vae"], "clip": params["clip"], "unet": params["unet"],
              "static": params["controlnet"]["static"], "controlnet": params["controlnet"]}
    lora = flatten(distill.init_unet_lora_params(gen, params["unet"], 8))
    lora = {k: 0.02 * torch.randn(v.shape, generator=gen, device=cuda) if k[-1] == "up" else v
            for k, v in lora.items()}
    img = lambda: 0.5 * torch.randn((1, 1, 3, 512, 512), generator=gen, device=cuda)  # noqa: E731
    batch = {k: img() for k in ("original", "agnostic", "head", "clothes", "clothes2")}
    batch.update({k: img().abs() for k in ("original_openpose", "clothes_openpose",
                                           "clothes_openpose2")})
    batch["input_ids"] = torch.randint(1, 99, (1, 1, 7), generator=gen, device=cuda)
    cfg = distill.DistillConfig(lora_rank=8)
    draws = distill.sample_distill_draws(pipe, cfg, batch, gen)[0]
    mb = {k: v[0] for k, v in batch.items()}
    uctx = pipe.clip(frozen["clip"], mb["input_ids"])["last_hidden_state"].detach()
    sched = distill.SCHEDULE.to(cuda)

    def grads():
        leaves = {k: v.detach().requires_grad_(True) for k, v in lora.items()}
        loss = distill.distill_loss_fn(unflatten(leaves), None, frozen, pipe, sched, cfg, mb,
                                       uctx, draws)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    kernels.reset_launches()
    g_k = grads()
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES.values()), kernels.LAUNCHES
    monkeypatch.setattr(layers, "norm_act_conv3x3", fused_conv.norm_act_conv3x3_reference)
    monkeypatch.setattr(attention, "flash_attention", flash.flash_attention_reference)
    kernels.reset_launches()
    g_p = grads()
    torch.cuda.synchronize()
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    for group in GROUPS:
        keys = [k for k in g_p if _group(k) == group]
        diff = math.sqrt(sum((g_k[k].float() - g_p[k].float()).square().sum().item()
                             for k in keys))
        norm = math.sqrt(sum(g_p[k].float().square().sum().item() for k in keys))
        assert norm > 0 and diff <= GRAD_TOL * norm, (group, diff / norm)

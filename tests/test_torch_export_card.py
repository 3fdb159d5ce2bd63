"""The deployment export on the card (marked ``gpu``; skipped without one):
the MID denoise step (4 UNet levels of 64-256 channels, two layers a
block, the six-branch pattern, bf16, 32 x 32 latents so level 0 reaches the
flash kernel) exported by apps/export.py, reloaded, and held to the live
step on the same inputs, with the kernels' launches the code predicts. The
file imports nothing of JAX or of the JAX package, so it runs where only the
port's dependencies are installed.
"""

import numpy as np
import pytest
import torch

from edgestyle_tpu_torch import kernels
from edgestyle_tpu_torch.apps import export
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.export import load_program
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig
from edgestyle_tpu_torch.models.unet import UNetConfig
from edgestyle_tpu_torch.models.vae import VAEConfig
from edgestyle_tpu_torch.pipelines.artifact import stage_params
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

MID_BF16 = PipelineConfig(
    unet=UNetConfig(block_out_channels=(64, 128, 256, 256), layers_per_block=2,
                    cross_attention_dim=96, num_heads=4, cond_embedding_channels=(16, 32, 64, 64)),
    vae=VAEConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=2, sample_size=256),
    clip=CLIPTextConfig(vocab_size=128, hidden_size=96, num_layers=2, num_heads=4,
                        max_positions=16, intermediate_size=192),
    dtype="bfloat16")
# a step at these widths, from the code: 1,024 tokens at level 0 only, so
# flash in each trunk's down block 0 (2 layers, 3 trunk calls) and the
# UNet's down (2) and up (3) blocks 0; two fused convs per ResNet block:
# each trunk 4 x 2 + 2, the UNet 4 x 2 + 2 + 4 x 3
STEP_LAUNCHES = {"flash_fwd": 3 * 2 + 2 + 3, "gn_scale_shift": 2 * (3 * 10 + 22),
                 "fused_gn_silu_conv3x3": 2 * (3 * 10 + 22), "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_reloaded_denoise_step_matches_the_live_step(cuda, tmp_path):
    """apps/export.py --what unet_controlnet at MID width, bf16: the
    reloaded graph on new inputs equals the live step bit for bit (the same
    operators and kernels on the same inputs) and launches what the live
    step launches."""
    export.main(["--random_init", "--what", "unet_controlnet", "--output_dir", str(tmp_path)],
                config=MID_BF16, device=cuda)
    prog = load_program(str(tmp_path / "unet_controlnet.pt2"))
    pipe = EdgeStylePipeline(MID_BF16, device=cuda)
    params = pipe.init_params(make_generator(3, cuda))
    gen = make_generator(4, cuda)
    ids = torch.randint(1, 128, (2, 1, 16), generator=gen, device=cuda)
    imgs = [torch.rand((1, 3, 256, 256), generator=gen, device=cuda).contiguous(
        memory_format=torch.channels_last) for _ in range(6)]
    with torch.no_grad():
        ctx = pipe.encode_prompt(params, ids[0], ids[1])
        embs = [torch.cat([e, e]) for e in pipe.embed_cond_images(params, imgs)]
    sample = torch.randn((1, 4, 32, 32), generator=gen, device=cuda).contiguous(
        memory_format=torch.channels_last)
    t, g = torch.tensor(321, device=cuda), torch.tensor(4.0, device=cuda)
    outs = {}
    for which in ("live", "graph"):
        kernels.reset_launches()
        with torch.no_grad():
            outs[which] = (pipe._eval_step(True, params, ctx, None, embs, np.ones(6, np.float32),
                                           g, 1, False, sample, t) if which == "live" else
                           prog.call(stage_params("unet_controlnet", params), sample, t, ctx, embs,
                                     g))
        torch.cuda.synchronize()
        assert dict(kernels.LAUNCHES) == STEP_LAUNCHES, which
    assert torch.isfinite(outs["live"]).all()
    assert torch.equal(outs["graph"], outs["live"])

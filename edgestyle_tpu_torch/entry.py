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
"""

from __future__ import annotations

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, make_generator, resolve_device
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig


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

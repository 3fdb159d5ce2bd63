"""Photos and their pose keypoints -> try-on image, in one call.

Counterpart of edgestyle_tpu/pipelines/full.py (``FusedTryOn``): the
three photos' masks (one batched preprocessing call: one SAM encoding per
photo, five decodes, the mask algebra and the composites), the three pose
renders (one batched call), then the 6-branch generation of
``pipelines/tryon.py::EdgeStylePipeline._generate``. Pose detection stays
outside (its person assembly runs on the host), so keypoints come in.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from edgestyle_tpu_torch.models.openpose import render_pose
from edgestyle_tpu_torch.pipelines.preprocess import TryOnPreprocessor
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline


class FusedTryOn:
    """params: {'sam': ..., 'decoders': ..., 'gen': <EdgeStylePipeline params>}."""

    def __init__(self, preproc: TryOnPreprocessor, pipe: EdgeStylePipeline,
                 use_agnostic: bool = False):
        self.preproc = preproc
        self.pipe = pipe
        # branch 0 takes the head crop by default: the reference's
        # --use_agnostic_images is store_true and its README never sets it
        self.use_agnostic = use_agnostic

    @torch.no_grad()
    def __call__(self, params: Dict, subject01, clothes1_01, clothes2_01,
                 keypoints, prompt_ids, negative_prompt_ids,
                 generator: Optional[torch.Generator] = None, num_inference_steps: int = 20,
                 guidance_scale=3.5, latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Photos (3, H, W) in [0, 1]; keypoints (3, 18, 2) px, NaN = missing;
        ids (1, n). ``latents`` (1, 4, H/8, W/8) replace the draw from
        ``generator``. Returns (1, 3, H, W) in [0, 1]."""
        dev = self.pipe.device
        photos = torch.stack([torch.as_tensor(x) for x in (subject01, clothes1_01, clothes2_01)])
        photos = photos.to(dev, torch.float32)
        kps = torch.as_tensor(keypoints).to(dev, torch.float32)
        h, w = photos.shape[2:]
        ex = self.preproc(params, photos, kps)
        poses = render_pose(kps / torch.tensor([w, h], dtype=torch.float32, device=dev), (h, w))

        branch0 = ex.agnostic if self.use_agnostic else ex.head
        cond = [branch0[0:1] * 2.0 - 1.0, poses[0:1],
                ex.clothes[1:2] * 2.0 - 1.0, poses[1:2],
                ex.clothes[2:3] * 2.0 - 1.0, poses[2:3]]
        cond = [c.contiguous(memory_format=torch.channels_last) for c in cond]
        ids = torch.as_tensor(prompt_ids, device=dev).long()
        neg = torch.as_tensor(negative_prompt_ids, device=dev).long()
        scales = self.pipe._step_scales(num_inference_steps, None, 0.0, 1.0)
        return self.pipe._generate(params["gen"], ids, neg, cond, generator, num_inference_steps,
                                   guidance_scale, scales, latents, False)

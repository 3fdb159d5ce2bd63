"""The SAM encoder and the pose net on the card against the same port
code on the CPU, at the committed goldens' MID sizes (marked ``gpu``;
skipped without a card). The file imports nothing of JAX or of the JAX
package, so it runs where only the port's dependencies are installed.
"""

import json

import numpy as np
import pytest
import torch

from edgestyle_tpu_torch.core.porting import tree_from_flat
from edgestyle_tpu_torch.models import openpose
from edgestyle_tpu_torch.models.efficientvit.backbone import BackboneConfig
from edgestyle_tpu_torch.models.efficientvit.sam import (
    EfficientViTSam,
    SamConfig,
    port_sam_state_dict,
)
from tests import golden_mirror as gm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@torch.no_grad()
def test_sam_mid_on_the_card_matches_the_cpu(cuda):
    """SAM-MID in fp32 with TF32 off, card against CPU, same params and
    image: embedding and masks within 1e-4 of their largest magnitude."""
    with open(gm.SAM_SHAPES_JSON) as f:
        shapes = json.load(f)["sam_mid"]
    c = gm.SAM_MID
    cfg = SamConfig(backbone=BackboneConfig(width_list=tuple(c["widths"]),
                                            depth_list=tuple(c["depths"])),
                    neck_depth=c["neck_depth"], image_size=c["image_size"])
    flat = port_sam_state_dict(gm.synth_state_dict(shapes), cfg)
    img, box_pts, box_lbl, _, _ = gm.sam_inputs()
    sam = EfficientViTSam(cfg)
    outs = []
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            p = tree_from_flat(flat, dev)
            emb = sam.encode_image(p, torch.from_numpy(img).to(dev))
            masks, _ = sam.decode(p, emb, torch.from_numpy(box_pts).to(dev),
                                  torch.from_numpy(box_lbl).to(dev))
            outs.append((emb.cpu(), masks.cpu()))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    for a, b in zip(*outs):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.gpu
@torch.no_grad()
def test_bodypose_on_the_card_matches_the_cpu(cuda):
    """The pose net at 184 px, fp32 with TF32 off, card against CPU: 1e-4
    of the largest magnitude."""
    shapes = gm.load_shapes()["bodypose"]
    flat = openpose.port_bodypose_state_dict(gm.synth_state_dict(shapes))
    x = np.random.default_rng(14).random((2, 3, 184, 184)).astype(np.float32) - 0.5
    outs = []
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            paf, heat = openpose.BodyPoseNet()(tree_from_flat(flat, dev),
                                               torch.from_numpy(x).to(dev))
            outs.append((paf.cpu(), heat.cpu()))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(*outs):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()

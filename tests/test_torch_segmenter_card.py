"""One segmenter finetuning step on the card against the same port code on
the CPU, at the committed goldens' SAM-MID size (marked ``gpu``; skipped
without a card). The file imports nothing of JAX or of the JAX package, so
it runs where only the port's dependencies are installed.
"""

import json

import numpy as np
import pytest
import torch

from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.porting import tree_from_flat
from edgestyle_tpu_torch.models.efficientvit.backbone import BackboneConfig
from edgestyle_tpu_torch.models.efficientvit.sam import (
    EfficientViTSam,
    SamConfig,
    port_sam_state_dict,
)
from edgestyle_tpu_torch.training import segmenter as seg
from tests import golden_mirror as gm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_segmenter_step_mid_on_the_card_matches_the_cpu(cuda):
    """SAM-MID (256 px) in fp32 with TF32 off, head "body", two examples
    (one without any body label, so its box is JAX's zero box, jittered),
    the same box noise: the loss within 1e-5 relative and each decoder
    gradient leaf within 1e-3 relative L2 (the key-projection biases, whose
    exact gradient is 0, and the leaves the loss never reaches, against the
    whole gradient's norm); one Prodigy step runs on both."""
    with open(gm.SAM_SHAPES_JSON) as f:
        shapes = json.load(f)["sam_mid"]
    c = gm.SAM_MID
    cfg = SamConfig(backbone=BackboneConfig(width_list=tuple(c["widths"]),
                                            depth_list=tuple(c["depths"])),
                    neck_depth=c["neck_depth"], image_size=c["image_size"])
    flat = port_sam_state_dict(gm.synth_state_dict(shapes), cfg)
    s = cfg.image_size
    g = np.random.default_rng(21)
    image = g.standard_normal((2, 3, s, s)).astype(np.float32)
    labels = np.zeros((2, s, s), np.int64)
    labels[0, 40:200, 60:190] = 12
    labels[0, 10:40, 100:150] = 2
    labels[1, 50:150, 50:150] = 4
    noise = torch.tensor([[4, -9, 13, 0], [-30, 30, 7, -1]])
    sam = EfficientViTSam(cfg)
    tcfg = seg.SegmenterTrainConfig(head="body")
    out = []
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            p = tree_from_flat(flat, dev)
            batch = {"image": torch.from_numpy(image).to(dev),
                     "labels": torch.from_numpy(labels).to(dev)}
            loss, grads = seg.segmenter_grads(sam, tcfg, p["mask_decoder"], p, batch,
                                              noise.to(dev))
            state, _ = seg.make_segmenter_train_step(sam, tcfg)(
                seg.init_segmenter_state(p, tcfg), p, batch, noise.to(dev))
            assert all(torch.isfinite(v).all() for v in flatten(state["decoder"]).values())
            out.append((float(loss), {k: v.cpu().double() for k, v in flatten(grads).items()}))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    total = float(torch.sqrt(sum(v.square().sum() for v in g_cpu.values())))
    for k, want in g_cpu.items():
        n = float(want.norm())
        scale = total if k[-2:] == ("k_proj", "bias") or n == 0 else n
        assert float((g_card[k] - want).norm()) <= 1e-3 * scale, k

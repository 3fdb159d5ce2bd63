"""The CLIP vision tower and CLIP's preprocessing on the card against the
same port code on the CPU (marked ``gpu``; skipped without a card). The file
imports nothing of JAX or of the JAX package, so it runs where only the
port's dependencies are installed.
"""

import numpy as np
import pytest
import torch

from edgestyle_tpu_torch.core.params import InitTree, materialize
from edgestyle_tpu_torch.models.clip_vision import (
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    clip_preprocess,
)

# 224 px like ViT-L/14 (257 tokens), narrower and shallower
MID_VISION = CLIPVisionConfig(hidden_size=256, num_layers=4, num_heads=4,
                              intermediate_size=1024, projection_dim=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.cpu() - want).abs().max() / max(1.0, float(want.abs().max())))


@pytest.mark.gpu
@torch.no_grad()
def test_vision_tower_on_the_card_matches_the_cpu(cuda):
    """MID_VISION in fp32 with TF32 off, from the port's own init: the
    hidden states, the pooled output and the image embeds within 1e-4 of
    their largest magnitude."""
    model = CLIPVisionModelWithProjection(MID_VISION)
    tree = InitTree()
    model(tree, torch.zeros((1, 3, 224, 224), device="meta"))
    params = materialize(tree, torch.Generator().manual_seed(0), torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 224, 224))
                         .astype(np.float32))
    want = model(params, x)
    got = model(_to(params, cuda), x.to(cuda))
    for k in ("last_hidden_state", "pooled_output", "image_embeds"):
        assert got[k].device.type == "cuda"
        assert scaled_err(got[k], want[k]) < 1e-4, k


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


@pytest.mark.gpu
def test_clip_preprocess_on_the_card_matches_the_cpu(cuda):
    """512 -> 224 through the host-built cubic matrices, fp32: within 1e-5."""
    x = torch.from_numpy(np.random.default_rng(1).random((2, 3, 512, 512), dtype=np.float32))
    got = clip_preprocess(x.to(cuda))
    assert got.device.type == "cuda" and got.shape == (2, 3, 224, 224)
    assert scaled_err(got, clip_preprocess(x)) < 1e-5

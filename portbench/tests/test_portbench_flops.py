"""The model-FLOP counter (``FlopCounterMode`` over the plain reference on
the meta device) against hand counts of one ResNet block and one
transformer block."""

import torch

from portbench.reference import sd15
from portbench.roofline import counted_flops

META = torch.device("meta")


def test_resnet_block():
    with META:
        blk = sd15.ResnetBlock2D(32, 64, temb_dim=128)
        x, temb = torch.empty(1, 32, 8, 8), torch.empty(1, 128)
    hand = (2 * 8 * 8 * 32 * 64 * 9      # conv1
            + 2 * 128 * 64               # time_emb_proj
            + 2 * 8 * 8 * 64 * 64 * 9    # conv2
            + 2 * 8 * 8 * 32 * 64)       # 1x1 shortcut
    assert counted_flops(blk, x, temb) == hand


def test_transformer_block():
    n, c, m, cc, heads = 64, 32, 7, 16, 2
    with META:
        blk = sd15.BasicTransformerBlock(c, cc, heads)
        x, ctx = torch.empty(1, n, c), torch.empty(1, m, cc)
    self_attn = 3 * 2 * n * c * c + 2 * (2 * n * n * c) + 2 * n * c * c
    cross_attn = 2 * n * c * c + 2 * (2 * m * cc * c) + 2 * (2 * n * m * c) + 2 * n * c * c
    ff = 2 * n * c * (8 * c) + 2 * n * (4 * c) * c
    assert counted_flops(blk, x, ctx) == self_attn + cross_attn + ff

"""EfficientViT large backbone (l0-l3).

Counterpart of edgestyle_tpu/models/efficientvit/backbone.py (reference
efficientvit/models/efficientvit/backbone.py:203-338): a conv stem and
ResBlocks, three conv stages (first block stride 2 and expand 16, the rest
expand 4 and residual; stages 1-2 FusedMBConv, stage 3 MBConv with fewer
norms), then a stride-2 MBConv (expand 24) and N EfficientViT blocks.
Returns the stage features the SAM neck reads.

l2: widths (32, 64, 128, 256, 512), depths (1, 2, 2, 8, 8); a 512 px input
gives stages at 256/128/64/32/16 px.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from edgestyle_tpu_torch.core.params import sub
from edgestyle_tpu_torch.models.efficientvit.ops import (
    conv_layer,
    efficientvit_block,
    fused_mb_conv,
    mb_conv,
    res_block,
)


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    width_list: Tuple[int, ...] = (32, 64, 128, 256, 512)
    depth_list: Tuple[int, ...] = (1, 2, 2, 8, 8)
    qkv_dim: int = 32
    act: str = "gelu"


L0 = BackboneConfig(depth_list=(1, 1, 1, 4, 4))
L1 = BackboneConfig(depth_list=(1, 1, 1, 6, 6))
L2 = BackboneConfig(depth_list=(1, 2, 2, 8, 8))
L3 = BackboneConfig(width_list=(64, 128, 256, 512, 1024), depth_list=(1, 2, 2, 8, 8))


class EfficientViTLargeBackbone:
    def __init__(self, cfg: BackboneConfig = L2, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.norm_eps = norm_eps
        self.dtype = dtype

    def __call__(self, p, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg, eps, dt = self.cfg, self.norm_eps, self.dtype
        w, d = cfg.width_list, cfg.depth_list
        out: Dict[str, torch.Tensor] = {"input": x}

        x = conv_layer(sub(p, "stage0_stem"), x, w[0], 3, 2, norm="bn", act=cfg.act,
                       norm_eps=eps, dtype=dt)
        for j in range(d[0]):
            x = x + res_block(sub(p, f"stage0_block_{j}"), x, w[0], 1, expand_ratio=1,
                              norm=("bn", "bn"), act=(cfg.act, None), norm_eps=eps, dtype=dt)
        out["stage0"] = x

        for sid in (1, 2, 3):
            fewer = sid > 2
            for j in range(d[sid] + 1):
                stride = 2 if j == 0 else 1
                kw = dict(out_channels=w[sid], stride=stride,
                          expand_ratio=16 if stride == 2 else 4, norm_eps=eps, dtype=dt)
                blk = sub(p, f"stage{sid}_block_{j}")
                if sid <= 2:
                    y = fused_mb_conv(blk, x, use_bias=(False, False), norm=("bn", "bn"),
                                      act=(cfg.act, None), **kw)
                else:
                    y = mb_conv(blk, x, use_bias=(True, True, False) if fewer else (False,) * 3,
                                norm=(None, None, "bn") if fewer else ("bn",) * 3,
                                act=(cfg.act, cfg.act, None), **kw)
                x = y if stride == 2 else x + y
            out[f"stage{sid}"] = x

        x = mb_conv(sub(p, "stage4_block_0"), x, w[4], 2, expand_ratio=24,
                    use_bias=(True, True, False), norm=(None, None, "bn"),
                    act=(cfg.act, cfg.act, None), norm_eps=eps, dtype=dt)
        for j in range(d[4]):
            x = efficientvit_block(sub(p, f"stage4_vit_{j}"), x, dim=cfg.qkv_dim, expand_ratio=6,
                                   act=cfg.act, norm_eps=eps, dtype=dt)
        out["stage4"] = x
        out["stage_final"] = x
        return out

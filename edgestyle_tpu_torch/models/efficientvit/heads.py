"""EfficientViT b-series backbone and the classification / segmentation heads.

Counterpart of edgestyle_tpu/models/efficientvit/heads.py (the reference's
efficientvit/models/efficientvit/{backbone.py:37-160, seg.py:34-106,
cls.py:28-51}): the b0-b3 backbones, ``seg_head`` and ``cls_head``, and the
upstream state-dict mappers. EdgeStyle itself runs only the l2 SAM; these
complete the model zoo (models/efficientvit/zoo.py). Each block is a
function of its param subtree, with the JAX module's names; images NCHW.

b-series against the large backbone: DSConv stem blocks, MBConv conv stages
(expand 4, every norm), EfficientViT blocks in stages 3 and 4, hswish.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from edgestyle_tpu_torch.core.params import sub
from edgestyle_tpu_torch.models.efficientvit.ops import (
    act_fn,
    conv_layer,
    ds_conv,
    efficientvit_block,
    fused_mb_conv,
    mb_conv,
)
from edgestyle_tpu_torch.models.layers import dense, layer_norm_block
from edgestyle_tpu_torch.ops.resize import torch_bicubic_resize


@dataclasses.dataclass(frozen=True)
class BBackboneConfig:
    width_list: Tuple[int, ...] = (8, 16, 32, 64, 128)
    depth_list: Tuple[int, ...] = (1, 2, 2, 2, 2)
    dim: int = 16
    expand_ratio: float = 4
    act: str = "hswish"


B0 = BBackboneConfig()
B1 = BBackboneConfig(width_list=(16, 32, 64, 128, 256), depth_list=(1, 2, 3, 3, 4), dim=16)
B2 = BBackboneConfig(width_list=(24, 48, 96, 192, 384), depth_list=(1, 3, 4, 4, 6), dim=32)
B3 = BBackboneConfig(width_list=(32, 64, 128, 256, 512), depth_list=(1, 4, 6, 6, 9), dim=32)


class EfficientViTBackbone:
    """The b-series backbone (reference backbone.py:37-160): ``__call__(p,
    x)`` returns the stage features {input, stage0..stage4, stage_final}."""

    def __init__(self, cfg: BBackboneConfig = B1, norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.norm_eps = norm_eps
        self.dtype = dtype

    def __call__(self, p, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg, eps, dt = self.cfg, self.norm_eps, self.dtype
        w, d, act = cfg.width_list, cfg.depth_list, cfg.act
        out: Dict[str, torch.Tensor] = {"input": x}

        x = conv_layer(sub(p, "stem_in"), x, w[0], 3, 2, norm="bn", act=act, norm_eps=eps,
                       dtype=dt)
        for j in range(d[0]):
            x = x + ds_conv(sub(p, f"stem_{j}"), x, w[0], 1, use_bias=(False, False),
                            norm=("bn", "bn"), act=(act, None), norm_eps=eps, dtype=dt)
        out["stage0"] = x

        for sid in (1, 2):
            for j in range(d[sid]):
                stride = 2 if j == 0 else 1
                y = mb_conv(sub(p, f"stage{sid}_block_{j}"), x, w[sid], stride,
                            expand_ratio=cfg.expand_ratio, norm=("bn",) * 3,
                            act=(act, act, None), norm_eps=eps, dtype=dt)
                x = y if stride == 2 else x + y
            out[f"stage{sid}"] = x

        for sid in (3, 4):
            x = mb_conv(sub(p, f"stage{sid}_down"), x, w[sid], 2,
                        expand_ratio=cfg.expand_ratio, use_bias=(True, True, False),
                        norm=(None, None, "bn"), act=(act, act, None), norm_eps=eps, dtype=dt)
            for j in range(d[sid]):
                x = efficientvit_block(sub(p, f"stage{sid}_vit_{j}"), x, dim=cfg.dim,
                                       expand_ratio=cfg.expand_ratio, act=act, norm_eps=eps,
                                       dtype=dt)
            out[f"stage{sid}"] = x
        out["stage_final"] = x
        return out


def cls_head(p, feats: Dict[str, torch.Tensor], widths: Tuple[int, int] = (1024, 1280),
             num_classes: int = 1000, act: str = "hswish", norm_eps: float = 1e-5,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """1x1 ConvLayer to widths[0] -> global average pool -> bias-free Dense
    to widths[1] -> LayerNorm -> act -> Dense to the classes (reference
    cls.py:28-51). Returns (B, num_classes)."""
    x = conv_layer(sub(p, "conv"), feats["stage_final"], widths[0], 1, norm="bn", act=act,
                   norm_eps=norm_eps, dtype=dtype)
    x = x.mean(dim=(2, 3))
    x = dense(sub(p, "fc1"), x, widths[1], dtype, use_bias=False)
    x = act_fn(act)(layer_norm_block(sub(p, "norm"), x, norm_eps))
    return dense(sub(p, "fc2"), x, num_classes, dtype)


def seg_head(p, feats: Dict[str, torch.Tensor], head_width: int = 64, head_depth: int = 3,
             num_classes: int = 19, expand_ratio: float = 4, middle_op: str = "mbconv",
             final_expand: Optional[float] = 4, act: str = "hswish", norm_eps: float = 1e-5,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Multi-scale fusion (reference seg.py:34-106): stage4, stage3 and stage2
    each through a 1x1 ConvLayer (bn, no act), torch-exact bicubic to
    stage2's size, summed -> ``head_depth`` residual middle blocks (MBConv,
    or FusedMBConv for the l-series) -> an optional ``final_expand`` 1x1
    ConvLayer -> the 1x1 classifier conv. Returns (B, num_classes, H/8,
    W/8)."""
    target = tuple(feats["stage2"].shape[2:])
    x = None
    for fid in ("stage4", "stage3", "stage2"):
        y = conv_layer(sub(p, f"input_{fid}"), feats[fid], head_width, 1, norm="bn", act=None,
                       norm_eps=norm_eps, dtype=dtype)
        y = torch_bicubic_resize(y, target)
        x = y if x is None else x + y
    for j in range(head_depth):
        if middle_op == "mbconv":
            y = mb_conv(sub(p, f"middle_{j}"), x, head_width, expand_ratio=expand_ratio,
                        norm=("bn",) * 3, act=(act, act, None), norm_eps=norm_eps, dtype=dtype)
        else:
            y = fused_mb_conv(sub(p, f"middle_{j}"), x, head_width, expand_ratio=expand_ratio,
                              norm=("bn", "bn"), act=(act, None), norm_eps=norm_eps,
                              dtype=dtype)
        x = x + y
    if final_expand is not None:
        x = conv_layer(sub(p, "final_expand"), x, round(head_width * final_expand), 1,
                       norm="bn", act=act, norm_eps=norm_eps, dtype=dtype)
    return conv_layer(sub(p, "out"), x, num_classes, 1, use_bias=True, norm=None, act=None,
                      dtype=dtype)


# --------------------------------------------------------------------------
# Upstream EfficientViTSeg / EfficientViTCls state dicts (``backbone.*`` and
# ``head.*``, reference seg.py:109-121 / cls.py:55-66) -> the port's flat
# {dotted path: leaf} under ``backbone`` and ``head``, with the SAM mapper's
# rule helpers (models/efficientvit/sam.py).
# --------------------------------------------------------------------------
def b_backbone_rules(rules, cfg: BBackboneConfig) -> None:
    from edgestyle_tpu_torch.models.efficientvit.sam import _conv_layer, _mb, _vit_block

    d = cfg.depth_list
    B = r"backbone"
    _conv_layer(rules, B + r"\.input_stem\.op_list\.0", "backbone.stem_in")
    for j in range(d[0]):
        tp, fp = B + rf"\.input_stem\.op_list\.{j + 1}\.main", f"backbone.stem_{j}"
        _conv_layer(rules, tp + r"\.depth_conv", fp + ".depth_conv")
        _conv_layer(rules, tp + r"\.point_conv", fp + ".point_conv")
    for sid in (1, 2):
        for i in range(d[sid]):
            _mb(rules, B + rf"\.stages\.{sid - 1}\.op_list\.{i}\.main",
                f"backbone.stage{sid}_block_{i}")
    for sid in (3, 4):
        s = sid - 1
        _mb(rules, B + rf"\.stages\.{s}\.op_list\.0\.main", f"backbone.stage{sid}_down",
            (False, False, True))
        for i in range(d[sid]):
            _vit_block(rules, B + rf"\.stages\.{s}\.op_list\.{i + 1}",
                       f"backbone.stage{sid}_vit_{i}")


def seg_head_rules(rules, head_depth: int, final_expand: Optional[float],
                   middle_op: str) -> None:
    from edgestyle_tpu_torch.models.efficientvit.sam import _conv_layer, _fmb, _mb

    for i, fid in enumerate(("stage4", "stage3")):
        _conv_layer(rules, rf"head\.input_ops\.{i}\.op_list\.0", f"head.input_{fid}")
    _conv_layer(rules, r"head\.input_ops\.2", "head.input_stage2")
    for j in range(head_depth):
        (_mb if middle_op == "mbconv" else _fmb)(rules, rf"head\.middle\.op_list\.{j}\.main",
                                                 f"head.middle_{j}")
    out_idx = 0
    if final_expand is not None:
        _conv_layer(rules, r"head\.output_ops\.0\.op_list\.0", "head.final_expand")
        out_idx = 1
    _conv_layer(rules, rf"head\.output_ops\.0\.op_list\.{out_idx}", "head.out", norm=False)


def cls_head_rules(rules) -> None:
    from edgestyle_tpu_torch.models.efficientvit.sam import _conv_layer, _weight_bias

    _conv_layer(rules, r"head\.op_list\.0", "head.conv")
    rules.append((r"head\.op_list\.2\.linear\.weight", "head.fc1.kernel"))
    _weight_bias(rules, r"head\.op_list\.2\.norm", "head.norm", "scale")
    _weight_bias(rules, r"head\.op_list\.3\.linear", "head.fc2")


def port_seg_state_dict(sd, cfg: BBackboneConfig, head_depth: int = 3,
                        final_expand: Optional[float] = 4, middle_op: str = "mbconv") -> Dict:
    """An upstream b-series EfficientViTSeg state dict -> flat {dotted path:
    leaf} (core/porting.py::tree_from_flat places it). Strict: a key no
    rule matches raises."""
    from edgestyle_tpu_torch.core.porting import KeyMapper

    rules = []
    b_backbone_rules(rules, cfg)
    seg_head_rules(rules, head_depth, final_expand, middle_op)
    return KeyMapper(rules).apply(sd)


def port_cls_state_dict(sd, cfg: BBackboneConfig) -> Dict:
    """An upstream b-series EfficientViTCls state dict -> flat {dotted path:
    leaf}. Strict."""
    from edgestyle_tpu_torch.core.porting import KeyMapper

    rules = []
    b_backbone_rules(rules, cfg)
    cls_head_rules(rules)
    return KeyMapper(rules).apply(sd)

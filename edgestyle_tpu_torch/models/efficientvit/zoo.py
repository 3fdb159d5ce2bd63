"""EfficientViT model zoo: name -> model registries.

Counterpart of edgestyle_tpu/models/efficientvit/zoo.py (the reference's
efficientvit/{seg,cls,sam}_model_zoo.py and the builders of
models/efficientvit/{seg.py, cls.py, backbone.py}). Each ``create_*``
returns ``(model, port_fn)``: a model with ``__call__(params, x)`` and
``init_params(generator)``, as ``EfficientViTSam`` has, and a function
that maps the matching upstream checkpoint (a state dict of tensors or
numpy arrays) onto the model's param tree, strictly, on ``device``
(core/porting.py::tree_from_flat). Norm eps follows the reference runtime
(``set_norm_eps``): 1e-5 for the b-series, 1e-7 for the l-series seg and
cls models, 1e-6 for SAM. No weights are downloaded.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from edgestyle_tpu_torch.core.device import DeviceLike
from edgestyle_tpu_torch.core.params import InitTree, materialize, sub
from edgestyle_tpu_torch.models.efficientvit.backbone import (
    L0,
    L1,
    L2,
    L3,
    BackboneConfig,
    EfficientViTLargeBackbone,
)
from edgestyle_tpu_torch.models.efficientvit.heads import (
    B0,
    B1,
    B2,
    B3,
    BBackboneConfig,
    EfficientViTBackbone,
    b_backbone_rules,
    cls_head,
    cls_head_rules,
    seg_head,
    seg_head_rules,
)
from edgestyle_tpu_torch.models.efficientvit.sam import (
    SAM_L0,
    SAM_L1,
    SAM_L2,
    EfficientViTSam,
    _backbone_rules,
    port_sam_state_dict,
)

B_BACKBONES: Dict[str, BBackboneConfig] = {"b0": B0, "b1": B1, "b2": B2, "b3": B3}
L_BACKBONES: Dict[str, BackboneConfig] = {"l0": L0, "l1": L1, "l2": L2, "l3": L3}

# the reference seg builders (seg.py:124-343): dataset -> name -> head kwargs
SEG_RECIPES: Dict[str, Dict[str, dict]] = {
    "cityscapes": {
        "b0": dict(head_width=32, head_depth=1, expand_ratio=4,
                   middle_op="mbconv", final_expand=4, num_classes=19),
        "b1": dict(head_width=64, head_depth=3, expand_ratio=4,
                   middle_op="mbconv", final_expand=4, num_classes=19),
        "b2": dict(head_width=96, head_depth=3, expand_ratio=4,
                   middle_op="mbconv", final_expand=4, num_classes=19),
        "b3": dict(head_width=128, head_depth=3, expand_ratio=4,
                   middle_op="mbconv", final_expand=4, num_classes=19),
        "l1": dict(head_width=256, head_depth=3, expand_ratio=1,
                   middle_op="fmbconv", final_expand=None, num_classes=19,
                   act="gelu"),
        "l2": dict(head_width=256, head_depth=5, expand_ratio=1,
                   middle_op="fmbconv", final_expand=None, num_classes=19,
                   act="gelu"),
    },
    "ade20k": {
        "b1": dict(head_width=64, head_depth=3, expand_ratio=4,
                   middle_op="mbconv", final_expand=None, num_classes=150),
        "b2": dict(head_width=96, head_depth=3, expand_ratio=4,
                   middle_op="mbconv", final_expand=None, num_classes=150),
        "b3": dict(head_width=128, head_depth=3, expand_ratio=4,
                   middle_op="mbconv", final_expand=None, num_classes=150),
        "l1": dict(head_width=128, head_depth=3, expand_ratio=4,
                   middle_op="fmbconv", final_expand=8, num_classes=150,
                   act="gelu"),
        "l2": dict(head_width=128, head_depth=3, expand_ratio=4,
                   middle_op="fmbconv", final_expand=8, num_classes=150,
                   act="gelu"),
    },
}

# the reference cls builders' widths (cls.py:55-166)
CLS_RECIPES: Dict[str, dict] = {
    "b0": dict(widths=(1024, 1280)),
    "b1": dict(widths=(1536, 1600)),
    "b2": dict(widths=(2304, 2560)),
    "b3": dict(widths=(2304, 2560)),
    "l1": dict(widths=(3072, 3200), act="gelu"),
    "l2": dict(widths=(3072, 3200), act="gelu"),
    "l3": dict(widths=(6144, 6400), act="gelu"),
}

SAM_CONFIGS = {"l0": SAM_L0, "l1": SAM_L1, "l2": SAM_L2}


class ZooModel:
    """A backbone and a head (reference EfficientViTSeg / EfficientViTCls,
    seg.py:109-121 / cls.py:55-66); params {'backbone', 'head'}."""

    def __init__(self, backbone, head: Callable, head_kwargs: dict, image_size: int):
        self.backbone = backbone
        self.head = head
        self.head_kwargs = head_kwargs
        self.image_size = image_size  # what init_params records at

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(sub(params, "backbone"), x)
        return self.head(sub(params, "head"), feats, **self.head_kwargs)

    def init_params(self, generator: torch.Generator) -> Dict:
        """Random init, drawn from ``generator`` on its device in recording
        order (core/params.py), every leaf fp32: BatchNorm's mean 0 and var
        1, its scale 1 and bias 0, LayerNorm's the same."""
        tree = InitTree()
        s = self.image_size
        self(tree, torch.zeros((1, 3, s, s), device="meta"))
        return materialize(tree, generator, torch.float32)


def _port(rules) -> Callable:
    """A strict state-dict -> param-tree function over ``rules``."""
    from edgestyle_tpu_torch.core.porting import KeyMapper, tree_from_flat

    mapper = KeyMapper(rules)

    def port(sd, device: DeviceLike = "cuda") -> Dict:
        return tree_from_flat(mapper.apply(sd), device)

    port.rules = rules
    return port


def _backbone(name: str, eps: float, dtype: torch.dtype):
    """(backbone model, its upstream rules) of a zoo name."""
    rules = []
    if name in B_BACKBONES:
        b_backbone_rules(rules, B_BACKBONES[name])
        return EfficientViTBackbone(B_BACKBONES[name], eps, dtype), rules
    _backbone_rules(rules, L_BACKBONES[name].depth_list, r"backbone", "backbone")
    return EfficientViTLargeBackbone(L_BACKBONES[name], eps, dtype), rules


def create_seg_model(name: str, dataset: str = "cityscapes",
                     dtype: torch.dtype = torch.float32) -> Tuple[ZooModel, Callable]:
    """Reference create_seg_model (seg_model_zoo.py:41-72) without the
    download: (model, port_fn). The model maps (B, 3, H, W) to (B,
    num_classes, H/8, W/8) logits."""
    recipes = SEG_RECIPES.get(dataset)
    if recipes is None or name not in recipes:
        known = sorted((d, n) for d, r in SEG_RECIPES.items() for n in r)
        raise ValueError(f"unknown seg model {name!r}/{dataset!r}; zoo: {known}")
    kw = dict(recipes[name])
    eps = 1e-7 if name.startswith("l") else 1e-5  # seg_model_zoo.py:61
    backbone, rules = _backbone(name, eps, dtype)
    seg_head_rules(rules, kw["head_depth"], kw["final_expand"], kw["middle_op"])
    model = ZooModel(backbone, seg_head, dict(kw, norm_eps=eps, dtype=dtype), 64)
    return model, _port(rules)


def create_cls_model(name: str, num_classes: int = 1000,
                     dtype: torch.dtype = torch.float32) -> Tuple[ZooModel, Callable]:
    """Reference create_cls_model (cls_model_zoo.py:52-81): (model,
    port_fn); the model maps (B, 3, H, W) to (B, num_classes) logits."""
    if name not in CLS_RECIPES:
        raise ValueError(f"unknown cls model {name!r}; zoo: {sorted(CLS_RECIPES)}")
    eps = 1e-7 if name.startswith("l") else 1e-5
    backbone, rules = _backbone(name, eps, dtype)
    cls_head_rules(rules)
    kw = dict(CLS_RECIPES[name], num_classes=num_classes, norm_eps=eps, dtype=dtype)
    return ZooModel(backbone, cls_head, kw, 64), _port(rules)


def create_sam_model(name: str, dtype: Optional[torch.dtype] = None
                     ) -> Tuple[EfficientViTSam, Callable]:
    """Reference create_sam_model (sam_model_zoo.py:26-55): (model,
    port_fn); norm eps 1e-6 is in the SamConfig."""
    from edgestyle_tpu_torch.core.porting import tree_from_flat

    if name not in SAM_CONFIGS:
        raise ValueError(f"unknown sam model {name!r}; zoo: {sorted(SAM_CONFIGS)}")
    cfg = SAM_CONFIGS[name]

    def port(sd, device: DeviceLike = "cuda") -> Dict:
        return tree_from_flat(port_sam_state_dict(sd, cfg), device)

    return EfficientViTSam(cfg, dtype=dtype or torch.float32), port

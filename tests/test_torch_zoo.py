"""The port's EfficientViT b-series heads and model zoo
(models/efficientvit/heads.py, zoo.py) against the JAX package's.

Geometry: every seg, cls and SAM recipe's param tree, recorded on the meta
device, against JAX's (``jax.eval_shape``, no FLOPs), the JAX tree carried
through ``from_jax_params``. The port functions: strict at the upstream key
names of tests/torch_sam.py's reference modules (built on the meta device)
for every recipe. Numbers: tests/test_heads_parity.py's TINY_B seg (both
recipes) and cls models and a tiny l-series seg, from one synthesised
upstream state dict through both packages' mappers, scaled max diff
<= 1e-5 (fp32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.models.efficientvit import zoo as jzoo
from edgestyle_tpu.models.efficientvit.backbone import BackboneConfig as JBackboneConfig
from edgestyle_tpu.models.efficientvit.backbone import EfficientViTLargeBackbone as JLarge
from edgestyle_tpu.models.efficientvit.heads import BBackboneConfig as JBBackboneConfig
from edgestyle_tpu.models.efficientvit.heads import ClsHead as JClsHead
from edgestyle_tpu.models.efficientvit.heads import EfficientViTBackbone as JBBackbone
from edgestyle_tpu.models.efficientvit.heads import SegHead as JSegHead
from edgestyle_tpu.models.efficientvit.heads import port_cls_state_dict as jport_cls
from edgestyle_tpu.models.efficientvit.heads import port_seg_state_dict as jport_seg
from edgestyle_tpu.models.efficientvit.sam import EfficientViTSam as JSam
from edgestyle_tpu_torch.core.params import InitTree, flatten
from edgestyle_tpu_torch.core.porting import KeyMapper, from_jax_params, tree_from_flat
from edgestyle_tpu_torch.models.efficientvit import zoo
from edgestyle_tpu_torch.models.efficientvit.backbone import (
    BackboneConfig,
    EfficientViTLargeBackbone,
)
from edgestyle_tpu_torch.models.efficientvit.heads import (
    BBackboneConfig,
    EfficientViTBackbone,
    cls_head,
    port_cls_state_dict,
    port_seg_state_dict,
    seg_head,
    seg_head_rules,
)
from edgestyle_tpu_torch.models.efficientvit.sam import _backbone_rules
from tests import golden_mirror as gm
from tests import torch_sam as T
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

ALL_SEG = [(d, n) for d, r in zoo.SEG_RECIPES.items() for n in r]
# tests/test_heads_parity.py's
TINY_B = BBackboneConfig(width_list=(8, 16, 32, 32, 64), depth_list=(1, 2, 1, 1, 2), dim=8)
TINY_L = BackboneConfig(width_list=(8, 16, 32, 64, 128), depth_list=(1, 1, 1, 2, 2))
TOL = 1e-5


def _recorded(model, s=64):
    """{dotted path: shape} of a zoo model's params and its output shape,
    recorded on the meta device."""
    tree = InitTree()
    out = model(tree, torch.zeros((1, 3, s, s), device="meta"))
    return {".".join(k): tuple(v.shape) for k, v in flatten(tree).items()}, tuple(out.shape)


def _jax_shapes(jtree):
    """JAX's eval_shape tree through from_jax_params: the port's layout."""
    conv = from_jax_params(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jtree), "cpu")
    return {".".join(k): tuple(v.shape) for k, v in flatten(conv).items()}


# ------------------------------------------------------------ geometry
@pytest.mark.parametrize("dataset,name", ALL_SEG)
def test_seg_zoo_geometry_matches_jax(dataset, name):
    jmodel, _ = jzoo.create_seg_model(name, dataset)
    jtree = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"]
    got, out = _recorded(zoo.create_seg_model(name, dataset)[0])
    assert got == _jax_shapes(jtree)
    assert out == (1, zoo.SEG_RECIPES[dataset][name]["num_classes"], 8, 8)  # stride 8


@pytest.mark.parametrize("name", sorted(zoo.CLS_RECIPES))
def test_cls_zoo_geometry_matches_jax(name):
    jmodel, _ = jzoo.create_cls_model(name, num_classes=1000)
    jtree = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))["params"]
    got, out = _recorded(zoo.create_cls_model(name)[0])
    assert got == _jax_shapes(jtree) and out == (1, 1000)


@pytest.mark.parametrize("name", sorted(zoo.SAM_CONFIGS))
def test_sam_zoo_matches_jax(name):
    """create_sam_model: JAX's tree geometry, norm eps 1e-6, an unknown
    name raises."""
    model, port = zoo.create_sam_model(name)
    jcfg = jzoo.SAM_CONFIGS[name]
    s = jcfg.image_size
    jtree = jax.eval_shape(JSam(jcfg).init, jax.random.key(0), jnp.zeros((1, s, s, 3)),
                           jnp.zeros((1, 2, 2)), jnp.zeros((1, 2), jnp.int32))["params"]
    tree = InitTree()
    emb = model.encode_image(tree, torch.zeros((1, 3, s, s), device="meta"))
    model.decode(tree, emb, torch.zeros((1, 2, 2), device="meta"),
                 torch.zeros((1, 2), dtype=torch.long, device="meta"))
    assert {".".join(k): tuple(v.shape) for k, v in flatten(tree).items()} == _jax_shapes(jtree)
    assert model.cfg.norm_eps == 1e-6 and callable(port)
    with pytest.raises(ValueError, match="unknown sam model"):
        zoo.create_sam_model("xl9")


def test_zoo_refuses_unknown_names_and_sets_eps():
    with pytest.raises(ValueError, match="unknown seg model"):
        zoo.create_seg_model("b0", "ade20k")
    with pytest.raises(ValueError, match="unknown cls model"):
        zoo.create_cls_model("b9")
    assert zoo.create_seg_model("l2", "ade20k")[0].head_kwargs["norm_eps"] == 1e-7
    assert zoo.create_seg_model("b1")[0].head_kwargs["norm_eps"] == 1e-5
    assert zoo.create_cls_model("l3")[0].backbone.norm_eps == 1e-7


# ---------------------------------------------- port functions, strict
def _torch_seg(name, dataset):
    kw = zoo.SEG_RECIPES[dataset][name]
    if name in zoo.B_BACKBONES:
        c = zoo.B_BACKBONES[name]
        tb = T.BBackboneT(c.width_list, c.depth_list, dim=c.dim)
    else:
        c = zoo.L_BACKBONES[name]
        tb = T.BackboneT(c.width_list, c.depth_list)
    w = c.width_list
    return T.EfficientViTSegT(tb, T.SegHeadT(
        (w[4], w[3], w[2]), kw["head_width"], kw["head_depth"], kw["num_classes"],
        expand=kw["expand_ratio"], final_expand=kw["final_expand"],
        act=kw.get("act", "hswish"), middle_op=kw["middle_op"]))


def _torch_cls(name):
    if name in zoo.B_BACKBONES:
        c = zoo.B_BACKBONES[name]
        tb = T.BBackboneT(c.width_list, c.depth_list, dim=c.dim)
    else:
        c = zoo.L_BACKBONES[name]
        tb = T.BackboneT(c.width_list, c.depth_list)
    kw = zoo.CLS_RECIPES[name]
    return T.EfficientViTClsT(tb, T.ClsHeadT(c.width_list[4], kw["widths"], n_classes=1000,
                                             act=kw.get("act", "hswish")))


def _check_port(model, port, tmod):
    """Every upstream key of the reference module maps (no key left over,
    every leaf filled at the recorded shape)."""
    with torch.device("meta"):
        sd = tmod().state_dict()
    flat = KeyMapper(port.rules).apply(sd)
    want, _ = _recorded(model)
    assert {k: tuple(v.shape) for k, v in flat.items()} == want


@pytest.mark.parametrize("dataset,name", ALL_SEG)
def test_seg_zoo_port_is_strict_at_upstream_names(dataset, name):
    model, port = zoo.create_seg_model(name, dataset)
    _check_port(model, port, lambda: _torch_seg(name, dataset))


@pytest.mark.parametrize("name", sorted(zoo.CLS_RECIPES))
def test_cls_zoo_port_is_strict_at_upstream_names(name):
    model, port = zoo.create_cls_model(name)
    _check_port(model, port, lambda: _torch_cls(name))


def test_zoo_port_fn_places_the_tree_and_refuses_stray_keys():
    """port_fn gives the tree on the device asked, bit for bit; an unknown
    upstream key raises."""
    model, port = zoo.create_seg_model("b0")
    sd = {k: torch.from_numpy(v) for k, v in gm.synth_state_dict(
        {k: list(v.shape) for k, v in _torch_seg("b0", "cityscapes").state_dict().items()},
        seed=3).items()}
    tree = port(sd, "cpu")
    want = tree_from_flat(port_seg_state_dict(sd, zoo.B_BACKBONES["b0"], 1, 4), "cpu")
    fa, fb = flatten(tree), flatten(want)
    assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    assert fa[("backbone", "stem_in", "conv", "kernel")].is_contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(KeyError, match="unported torch keys"):
        port({**sd, "head.extra.weight": torch.zeros(1)}, "cpu")


# ---------------------------------------------------------- numbers
def _synth(tmod, seed):
    return gm.synth_state_dict({k: list(v.shape) for k, v in tmod.state_dict().items()},
                               seed=seed)


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"scaled max diff {err:.2e}"


def _x(seed):
    return np.random.default_rng(seed).standard_normal((2, 3, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("middle_op,final_expand,act", [
    ("mbconv", 4, "hswish"),      # the b-series cityscapes recipe
    ("fmbconv", None, "gelu"),    # an l-series ade-style recipe
])
def test_seg_head_matches_jax(middle_op, final_expand, act):
    """TINY_B's backbone and a seg head from one upstream state dict
    through both packages' mappers: the (2, 5, 8, 8) logits."""
    c = TINY_B
    tmod = T.EfficientViTSegT(
        T.BBackboneT(c.width_list, c.depth_list, dim=c.dim),
        T.SegHeadT((c.width_list[4], c.width_list[3], c.width_list[2]), head_width=16,
                   head_depth=2, n_classes=5, final_expand=final_expand, act=act,
                   middle_op=middle_op))
    sd = _synth(tmod, 31 + (final_expand is None))
    jc = JBBackboneConfig(c.width_list, c.depth_list, c.dim)
    bp, hp = jport_seg(sd, jc, head_depth=2, final_expand=final_expand, middle_op=middle_op)
    head_kw = dict(head_width=16, head_depth=2, num_classes=5, middle_op=middle_op,
                   final_expand=final_expand, act=act)
    x = _x(5)

    @jax.jit
    def jfwd(bp, hp, x):
        feats = JBBackbone(jc).apply({"params": bp}, x)
        return JSegHead(**head_kw).apply({"params": hp}, feats)

    want = np.transpose(np.asarray(jfwd(bp, hp, jnp.asarray(x.transpose(0, 2, 3, 1)))),
                        (0, 3, 1, 2))
    p = tree_from_flat(port_seg_state_dict(sd, c, 2, final_expand, middle_op), "cpu")
    with torch.no_grad():
        got = seg_head(p["head"], EfficientViTBackbone(c)(p["backbone"], torch.from_numpy(x)),
                       **head_kw).numpy()
    assert got.shape == (2, 5, 8, 8)
    _close(got, want)


def test_cls_head_matches_jax():
    c = TINY_B
    tmod = T.EfficientViTClsT(T.BBackboneT(c.width_list, c.depth_list, dim=c.dim),
                              T.ClsHeadT(c.width_list[4], (48, 56), n_classes=11))
    sd = _synth(tmod, 77)
    jc = JBBackboneConfig(c.width_list, c.depth_list, c.dim)
    bp, hp = jport_cls(sd, jc)
    x = _x(6)

    @jax.jit
    def jfwd(bp, hp, x):
        return JClsHead(widths=(48, 56), num_classes=11).apply(
            {"params": hp}, JBBackbone(jc).apply({"params": bp}, x))

    want = np.asarray(jfwd(bp, hp, jnp.asarray(x.transpose(0, 2, 3, 1))))
    p = tree_from_flat(port_cls_state_dict(sd, c), "cpu")
    with torch.no_grad():
        got = cls_head(p["head"], EfficientViTBackbone(c)(p["backbone"], torch.from_numpy(x)),
                       widths=(48, 56), num_classes=11).numpy()
    assert got.shape == (2, 11)
    _close(got, want)


def test_large_seg_matches_jax():
    """A tiny l-series seg model (the l1-cityscapes head: fmbconv, expand 1,
    no final expand, gelu; eps 1e-7 as the zoo sets it) through the zoo's
    pieces: the large backbone's rules at the ``backbone`` prefix and the
    seg head's."""
    cfg = TINY_L
    tmod = T.EfficientViTSegT(
        T.BackboneT(cfg.width_list, cfg.depth_list),
        T.SegHeadT((128, 64, 32), head_width=32, head_depth=2, n_classes=7, expand=1,
                   final_expand=None, act="gelu", middle_op="fmbconv"))
    sd = _synth(tmod, 404)
    head_kw = dict(head_width=32, head_depth=2, num_classes=7, expand_ratio=1,
                   middle_op="fmbconv", final_expand=None, act="gelu", norm_eps=1e-7)
    jcfg = JBackboneConfig(width_list=cfg.width_list, depth_list=cfg.depth_list)
    bp, hp = jzoo._port_large_seg(jcfg, head_depth=2, final_expand=None,
                                  middle_op="fmbconv")(sd)
    jmodel = jzoo.SegModel(JLarge(jcfg, norm_eps=1e-7), JSegHead(**head_kw))
    x = _x(8)[:1]
    want = np.transpose(np.asarray(jax.jit(jmodel.apply)(
        {"params": {"backbone": bp, "head": hp}}, jnp.asarray(x.transpose(0, 2, 3, 1)))),
        (0, 3, 1, 2))
    rules = []
    _backbone_rules(rules, cfg.depth_list, r"backbone", "backbone")
    seg_head_rules(rules, 2, None, "fmbconv")
    model = zoo.ZooModel(EfficientViTLargeBackbone(cfg, 1e-7), seg_head, head_kw, 64)
    with torch.no_grad():
        got = model(tree_from_flat(KeyMapper(rules).apply(sd), "cpu"),
                    torch.from_numpy(x)).numpy()
    assert got.shape == (1, 7, 8, 8)
    _close(got, want)


def test_zoo_init_params_is_seeded_and_runs():
    """init_params draws the recorded tree from the generator (the same
    seed, the same leaves), fp32, and the model runs on it."""
    model, _ = zoo.create_cls_model("b0", num_classes=10)
    a = model.init_params(torch.Generator().manual_seed(0))
    b = model.init_params(torch.Generator().manual_seed(0))
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)
    assert all(v.dtype == torch.float32 for v in fa.values())
    with torch.no_grad():
        out = model(a, torch.zeros((1, 3, 32, 32)))
    assert out.shape == (1, 10) and torch.isfinite(out).all()

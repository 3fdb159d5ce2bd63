"""The port's preprocessing modules (resize, morphology, EfficientViT,
EfficientViT-SAM, OpenPose) against the JAX package's, on the CPU in fp32
at small sizes, and against the committed mirror goldens. (The card-only
tests are in tests/test_torch_preprocess_card.py.)

The same numpy inputs, made from seeds, go through both sides; JAX params
reach the port through ``from_jax_params``, the goldens' torch-keyed state
dicts through the port's own mappers. Each test states its tolerance.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.models.efficientvit import ops as jops
from edgestyle_tpu.models.efficientvit.sam import EfficientViTSam as JSam
from edgestyle_tpu.models.efficientvit.sam import SamConfig as JSamConfig
from edgestyle_tpu.models import openpose as jpose
from edgestyle_tpu.ops import morphology as jmorph
from edgestyle_tpu.ops.resize import torch_bicubic_resize as j_bicubic
from edgestyle_tpu_torch.core.porting import from_jax_params, tree_from_flat
from edgestyle_tpu_torch.models import openpose
from edgestyle_tpu_torch.models.efficientvit import ops
from edgestyle_tpu_torch.models.efficientvit.backbone import BackboneConfig
from edgestyle_tpu_torch.models.efficientvit.sam import (
    EfficientViTSam,
    SamConfig,
    port_sam_state_dict,
)
from edgestyle_tpu_torch.ops import morphology
from edgestyle_tpu_torch.ops.resize import linear_resize, torch_bicubic_resize
from tests import golden_mirror as gm
from tests.test_efficientvit import TINY_BB as J_TINY_BB
from tests.test_openpose import FULL_KPS, _synthetic_pose_maps

TINY_BB = BackboneConfig(width_list=(8, 16, 32, 64, 96), depth_list=(1, 1, 1, 1, 1), qkv_dim=8)
J_TINY_SAM = JSamConfig(backbone=J_TINY_BB, neck_depth=1, image_size=32)
TINY_SAM = SamConfig(backbone=TINY_BB, neck_depth=1, image_size=32)
ATOL = 1e-4  # fp32 both sides: summation order only


def nchw(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def scaled_close(got, want, atol, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err < atol, f"{msg}: scaled max diff {err:.2e} (tol {atol})"


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("hw,out", [((8, 8), (64, 64)), ((64, 48), (16, 12)),
                                    ((5, 12), (17, 7)), ((16, 16), (16, 16))])
def test_bicubic_resize_matches_jax(hw, out):
    """torch's own bicubic against the JAX matrices that emulate it (up,
    down, non-square, identity): 1e-5 absolute on N(0, 1) inputs."""
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: j_bicubic(a, out))(x))
    got = nhwc(torch_bicubic_resize(nchw(x), out))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw,out", [((512, 512), (184, 184)), ((256, 256), (512, 512)),
                                    ((256, 256), (32, 32)), ((30, 17), (11, 40))])
def test_linear_resize_matches_jax_image_resize(hw, out):
    """jax.image.resize's antialiased bilinear (the pose net's 512 -> 184,
    the SAM masks' 256 -> 512 and the TINY 256 -> 32): 1e-5 absolute on
    N(0, 1) inputs."""
    x = np.random.default_rng(1).standard_normal((2, 3, *hw)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax.image.resize(a, (2, 3, *out), "bilinear"))(x))
    np.testing.assert_allclose(linear_resize(torch.from_numpy(x), out).numpy(), want, atol=1e-5)


# -------------------------------------------------------------- morphology
def _random_masks(seed, b=3, h=40, w=36):
    """Blobby masks: thresholded smoothed noise, several components each."""
    g = np.random.default_rng(seed)
    noise = g.standard_normal((b, h // 4, w // 4))
    up = np.kron(noise, np.ones((4, 4)))[:, :h, :w]
    return up + 0.3 * g.standard_normal((b, h, w)) > 0.4


def _spiral(h=33, w=33):
    m = np.zeros((h, w), bool)
    for i, r in enumerate(range(0, h, 2)):
        m[r, :] = True
        if r + 1 < h:
            m[r + 1, w - 1 if i % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("name,args", [("dilate", (3, 2)), ("erode", (3, 1)), ("closing", (7,)),
                                       ("opening", (3,)), ("smooth_mask", (3, 3)),
                                       ("largest_component", ())])
def test_morphology_matches_jax(name, args):
    """Boolean results identical to JAX's, batched and per image."""
    masks = _random_masks(2)
    fn = getattr(morphology, name)
    jfn = jax.jit(lambda m: getattr(jmorph, name)(m, *args))
    got = fn(torch.from_numpy(masks), *args).numpy()
    for i, m in enumerate(masks):
        want = np.asarray(jfn(m))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(fn(torch.from_numpy(m[None]), *args).numpy()[0], want)


def test_largest_component_spiral_and_ties():
    """The serpentine region is one component (many sweeps); in a batch
    with an empty mask and two equal blobs (argmax's first label) every
    image equals JAX's answer."""
    spiral = _spiral()
    ties = np.zeros_like(spiral)
    ties[2:6, 2:6] = ties[20:24, 20:24] = True
    batch = np.stack([spiral, np.zeros_like(spiral), ties, spiral | ties])
    got = morphology.largest_component(torch.from_numpy(batch)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jmorph.largest_component))(batch))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], spiral)
    _, sweeps = morphology.component_labels(torch.from_numpy(spiral[None]))
    assert sweeps > 3  # the serpentine needs one sweep per few turns


def test_mask_bbox_and_composite_match_jax():
    masks = _random_masks(3)
    masks[1] = False
    img = np.random.default_rng(4).random((3, 40, 36, 3)).astype(np.float32)
    box = morphology.mask_bbox(torch.from_numpy(masks), margin=5).numpy()
    comp = nhwc(morphology.composite_gray(nchw(img), torch.from_numpy(masks)))
    for i in range(3):
        np.testing.assert_array_equal(box[i], np.asarray(jmorph.mask_bbox(masks[i], margin=5)))
        np.testing.assert_array_equal(comp[i], np.asarray(jmorph.composite_gray(img[i],
                                                                                 masks[i])))


# ------------------------------------------------------------ EfficientViT
def test_relu_linear_attention_matches_jax():
    qkv = np.random.default_rng(5).standard_normal((2, 6, 5, 3 * 2 * 8)).astype(np.float32)
    want = np.asarray(jops.relu_linear_attention(jnp.asarray(qkv), 8))
    got = nhwc(ops.relu_linear_attention(nchw(qkv), 8))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ATOL)


def random_params(init, seed):
    """A JAX param tree shaped by ``init`` (traced, never compiled), filled
    from numpy: kernels N(0, 1/fan_in), norm scales 1 + 0.2 N, biases and
    means 0.2 N, variances 1 + |N| (so every BatchNorm's affine is live),
    other leaves (embeddings, tokens, the PE matrix) N(0, 1)."""
    g = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        x = g.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1 + 0.2 * x
        if name in ("bias", "mean"):
            return 0.2 * x
        if name == "var":
            return 1 + np.abs(x)
        return x

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init)["params"])


@pytest.mark.parametrize("block", ["lite_mla", "efficientvit_block", "ds_conv"])
def test_efficientvit_blocks_match_jax(block):
    """LiteMLA (grouped and depthwise aggregation convs, the fp32 attention)
    and one EfficientViTBlock (+ MBConv) and a DSConv, fp32: 1e-4."""
    x = np.random.default_rng(6).standard_normal((2, 8, 8, 32)).astype(np.float32)
    mod, fn, kw = {
        "lite_mla": (jops.LiteMLA(32, dim=8, norm=(None, "bn")), ops.lite_mla,
                     dict(out_channels=32, dim=8, norm=(None, "bn"))),
        "efficientvit_block": (jops.EfficientViTBlock(dim=8, act="gelu"),
                               ops.efficientvit_block, dict(dim=8, act="gelu")),
        "ds_conv": (jops.DSConv(24, stride=2), ops.ds_conv, dict(out_channels=24, stride=2)),
    }[block]
    params = random_params(lambda: mod.init(jax.random.key(0), x), 7)
    want = np.asarray(jax.jit(lambda p, a: mod.apply({"params": p}, a))(params, x))
    got = nhwc(fn(port(params), nchw(x), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=ATOL)


# --------------------------------------------------------------------- SAM
@torch.no_grad()
def test_sam_mid_matches_committed_golden():
    """SAM-MID (every block family, the neck's real 8 -> 64 bicubic, the
    full prompt encoder and two-way decoder) through the port's own
    state-dict mapper against tests/goldens/sam_v1.npz, at
    test_goldens_committed.py's scaled tolerance 2e-4. No JAX run."""
    goldens = dict(np.load(gm.SAM_GOLDENS_NPZ))
    with open(gm.SAM_SHAPES_JSON) as f:
        shapes = json.load(f)["sam_mid"]
    c = gm.SAM_MID
    cfg = SamConfig(backbone=BackboneConfig(width_list=tuple(c["widths"]),
                                            depth_list=tuple(c["depths"])),
                    neck_depth=c["neck_depth"], image_size=c["image_size"])
    params = tree_from_flat(port_sam_state_dict(gm.synth_state_dict(shapes), cfg), "cpu")
    sam = EfficientViTSam(cfg)
    img, box_pts, box_lbl, pt_pts, pt_lbl = gm.sam_inputs()
    emb = sam.encode_image(params, torch.from_numpy(img))
    scaled_close(emb[:, ::32, ::8, ::8], goldens["sam_mid.emb_slice"], 2e-4, "sam emb")
    masks, iou = sam.decode(params, emb, torch.from_numpy(box_pts), torch.from_numpy(box_lbl))
    scaled_close(masks, goldens["sam_mid.box_masks"], 2e-4, "box masks")
    scaled_close(iou, goldens["sam_mid.box_iou"], 2e-4, "box iou")
    masks, iou = sam(params, torch.from_numpy(img), torch.from_numpy(pt_pts),
                     torch.from_numpy(pt_lbl), multimask_output=False)
    scaled_close(masks, goldens["sam_mid.pt_mask"], 2e-4, "pt mask")
    scaled_close(iou, goldens["sam_mid.pt_iou"], 2e-4, "pt iou")


@pytest.fixture(scope="module")
def tiny_sam():
    jsam = JSam(J_TINY_SAM)
    img = np.random.default_rng(8).standard_normal((2, 32, 32, 3)).astype(np.float32)
    pts = np.array([[[100.0, 200.0], [900.0, 700.0]], [[512.0, 30.0], [0.0, 0.0]]], np.float32)
    lbl = np.array([[2, 3], [1, -1]], np.int32)
    return jsam, random_params(lambda: jsam.init(jax.random.key(3), img, pts, lbl), 9), img, pts, lbl


@torch.no_grad()
def test_tiny_sam_from_jax_params_matches_jax(tiny_sam):
    """The JAX tree carried by from_jax_params (BatchNorm statistics,
    depthwise and grouped convs, the decoder's ConvTranspose kernels):
    embedding and both decodes at 1e-4 scaled."""
    jsam, params, img, pts, lbl = tiny_sam
    emb = jax.jit(lambda p, x: jsam.apply({"params": p}, x, method="encode_image"))(params, img)
    dec = jax.jit(lambda p, e, pt, lb, multi: jsam.apply({"params": p}, e, pt, lb, multi,
                                                         method="decode"),
                  static_argnums=4)
    sam, p = EfficientViTSam(TINY_SAM), port(params)
    got_emb = sam.encode_image(p, nchw(img))
    scaled_close(nhwc(got_emb), emb, 1e-4, "embedding")
    for multi in (True, False):
        masks, iou = dec(params, emb, pts, lbl, multi)
        got_m, got_iou = sam.decode(p, got_emb, torch.from_numpy(pts),
                                    torch.from_numpy(lbl).long(), multi)
        scaled_close(got_m, masks, 1e-4, f"masks multimask={multi}")
        scaled_close(got_iou, iou, 1e-4, f"iou multimask={multi}")


def test_conv_transpose_rule_with_a_non_symmetric_kernel():
    """A flax ConvTranspose (k=2, stride 2) with a kernel that differs under
    every flip and swap, on C_in == C_out (where only the flip would show),
    against the port's conv_transpose2d on the converted kernel: 1e-6."""
    import flax.linen as nn

    c = 4
    w = np.arange(2 * 2 * c * c, dtype=np.float32).reshape(2, 2, c, c) ** 1.5 / 100.0
    x = np.random.default_rng(10).standard_normal((1, 5, 6, c)).astype(np.float32)
    bias = np.linspace(-1, 1, c).astype(np.float32)
    want = nn.ConvTranspose(c, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": w, "bias": bias}}, x)
    p = from_jax_params({"upscale_conv1": {"kernel": w, "bias": bias}}, device="cpu")
    from edgestyle_tpu_torch.models.efficientvit.sam import conv_transpose_2x2

    got = conv_transpose_2x2(p["upscale_conv1"], nchw(x), c)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    assert tuple(p["upscale_conv1"]["kernel"].shape) == (c, c, 2, 2)
    generic = from_jax_params({"conv": {"kernel": w, "bias": bias}}, device="cpu")
    assert not torch.allclose(generic["conv"]["kernel"], p["upscale_conv1"]["kernel"])


def test_from_jax_params_keeps_norm_statistics_fp32_and_groups():
    """In a bf16 tree, BatchNorm's scale, bias, mean and var stay fp32; a
    depthwise HWIO kernel (3, 3, 1, C) becomes torch's (C, 1, 3, 3) and a
    grouped 1x1 (1, 1, in/g, out) becomes (out, in/g, 1, 1)."""
    g = np.random.default_rng(11)
    tree = {"norm": {k: g.standard_normal(6).astype(np.float32)
                     for k in ("scale", "bias", "mean", "var")},
            "dw": {"kernel": g.standard_normal((3, 3, 1, 6)).astype(np.float32)},
            "gp": {"kernel": g.standard_normal((1, 1, 2, 6)).astype(np.float32)}}
    p = from_jax_params(tree, device="cpu", dtype=torch.bfloat16)
    assert {v.dtype for v in p["norm"].values()} == {torch.float32}
    torch.testing.assert_close(p["norm"]["mean"], torch.from_numpy(tree["norm"]["mean"]))
    assert p["dw"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["dw"]["kernel"].float().numpy()[:, 0],
                                  torch.from_numpy(tree["dw"]["kernel"][:, :, 0]).permute(
                                      2, 0, 1).bfloat16().float().numpy())
    assert tuple(p["gp"]["kernel"].shape) == (6, 2, 1, 1)


# ---------------------------------------------------------------- OpenPose
@torch.no_grad()
def test_bodypose_matches_committed_golden():
    """The body-pose net through the port's own mapper against
    mirror_v1.npz's bodypose.paf / heat, 1e-4 scaled (the JAX golden test's)."""
    goldens = dict(np.load(gm.GOLDENS_NPZ))
    shapes = gm.load_shapes()["bodypose"]
    params = tree_from_flat(openpose.port_bodypose_state_dict(gm.synth_state_dict(shapes)), "cpu")
    paf, heat = openpose.BodyPoseNet()(params, torch.from_numpy(gm.bodypose_inputs()))
    scaled_close(paf, goldens["bodypose.paf"], 1e-4, "paf")
    scaled_close(heat, goldens["bodypose.heat"], 1e-4, "heat")


def test_pose_decode_matches_jax_and_recovers_the_person():
    """smooth_heatmaps, find_peaks (valid peaks exactly; ties in the
    stable order top_k uses), score_limb_candidates and the host assembly
    against JAX on the synthetic person of tests/test_openpose.py, which
    the decode must recover (within 1.5 px, as the JAX test)."""
    heat, paf = (np.asarray(a) for a in _synthetic_pose_maps(FULL_KPS))
    jheat = jax.jit(jpose.smooth_heatmaps)(heat)
    got_heat = openpose.smooth_heatmaps(nchw(heat), 3.0)
    np.testing.assert_allclose(nhwc(got_heat), np.asarray(jheat), atol=1e-6)

    jpk = jax.jit(jpose.find_peaks)(heat)
    pk = openpose.find_peaks(nchw(heat))
    np.testing.assert_array_equal(pk.valid.numpy(), np.asarray(jpk.valid))
    np.testing.assert_array_equal(pk.xy.numpy(), np.asarray(jpk.xy))
    np.testing.assert_allclose(pk.score.numpy(), np.asarray(jpk.score), atol=0)

    js, jok = jax.jit(jpose.score_limb_candidates)(paf, jpk)
    s, ok = openpose.score_limb_candidates(nchw(paf), pk)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    people = openpose.assemble_people_host(
        openpose.Peaks(*(t.numpy() for t in pk)), s.numpy(), ok.numpy())
    p = openpose.filter_and_pick_largest(people)
    assert p is not None and p["total_parts"] >= 15
    np.testing.assert_allclose(p["keypoints"], FULL_KPS, atol=1.5)


def test_render_pose_batched_matches_jax():
    """Two skeletons (one with missing joints) in one batched render against
    JAX's render vmapped over them: identical values."""
    kp = np.stack([FULL_KPS / 46.0, FULL_KPS / 50.0 + 0.05]).astype(np.float32)
    kp[1, 4:8] = np.nan
    got = nhwc(openpose.render_pose(torch.from_numpy(kp), (96, 80)))
    want = np.asarray(jax.jit(jax.vmap(lambda k: jpose.render_pose(k, (96, 80))))(kp))
    np.testing.assert_array_equal(got, want)


def test_preprocess_for_openpose_matches_jax():
    """512 -> 184 with jax.image.resize's antialiasing: 1e-5 absolute."""
    img = np.random.default_rng(13).random((1, 512, 512, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jpose.preprocess_for_openpose)(img))
    got = nhwc(openpose.preprocess_for_openpose(nchw(img)))
    assert got.shape == (1, 184, 184, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)

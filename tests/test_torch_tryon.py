"""The port's photos -> try-on path (TryOnPreprocessor, FusedTryOn,
TryOnSystem) against the JAX package and the committed
tests/goldens/fused_tryon_v1.npz, on the CPU in fp32 at the TINY sizes of
tests/fused_golden.py; plus the app's own rules (batched equals
sequential, unported flags refused, the CPU only when asked).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgestyle_tpu.pipelines.preprocess import TryOnPreprocessor as JPreprocessor
from edgestyle_tpu_torch.apps import tryon
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.porting import from_jax_params
from edgestyle_tpu_torch.models.openpose import BodyPoseNet
from edgestyle_tpu_torch.pipelines.full import FusedTryOn
from edgestyle_tpu_torch.pipelines.preprocess import TryOnPreprocessor
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests.fused_golden import GOLDEN_NPZ, build_fused
from tests.test_torch_pipeline import TINY_PIPE
from tests.test_torch_preprocess import TINY_SAM, nchw, nhwc


@pytest.fixture(scope="module")
def fused_golden_setup():
    """tests/fused_golden.py::build_fused (its configs, params and inputs),
    with the SAM init jitted (the values of the eager init; the eager one
    compiles op by op for a minute)."""
    init = JPreprocessor.init_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JPreprocessor, "init_params",
                   lambda self, rng: jax.jit(init, static_argnums=0)(self, rng))
        fused, params, inputs = build_fused()
    return fused, jax.tree.map(np.asarray, params), inputs


@pytest.mark.heavy
@torch.no_grad()
def test_preprocessor_matches_jax(fused_golden_setup):
    """TryOnPreprocessor at TINY size in fp32, the three golden photos in one
    batched call against JAX's per-photo calls: the masks disagree on at
    most 0.5% of pixels, the composites are equal within 1e-5 where the
    masks agree, the subject scores within 1e-4."""
    fused, params, i = fused_golden_setup
    jpre = fused.preproc
    photos = [np.asarray(i[k]) for k in ("subject", "clothes1", "clothes2")]
    kps = np.asarray(i["kps"])
    run = jax.jit(lambda p, im, kp: jpre(p, im, kp))
    want = [run(params, photos[j], kps[j]) for j in range(3)]
    pre = TryOnPreprocessor(TINY_SAM)
    got = pre(from_jax_params({"sam": params["sam"], "decoders": params["decoders"]},
                              device="cpu"), nchw(np.stack(photos)), torch.from_numpy(kps))
    for j in range(3):
        for name in ("agnostic_mask", "person_mask"):
            w = np.asarray(getattr(want[j], name))
            g = getattr(got, name)[j].numpy()
            assert (g != w).mean() <= 0.005, (j, name, (g != w).mean())
        for name in ("subject", "agnostic", "head", "clothes"):
            w = np.asarray(getattr(want[j], name))
            g = nhwc(getattr(got, name)[j:j + 1])[0]
            same = np.all(np.isclose(g, w, atol=1e-5), axis=-1)
            assert same.mean() >= 0.995, (j, name, same.mean())
        np.testing.assert_allclose(got.subject_score[j].numpy(),
                                   np.asarray(want[j].subject_score), atol=1e-4)


@pytest.mark.heavy
def test_fused_tryon_matches_committed_golden(fused_golden_setup):
    """The port's FusedTryOn on build_fused's params (carried by
    from_jax_params), photos, keypoints and ids, with the latents JAX draws
    from key(77), 3 UniPC steps, against fused_tryon_v1.npz at the JAX
    golden test's atol 2e-4, rtol 1e-3."""
    _, params, i = fused_golden_setup
    want = np.load(GOLDEN_NPZ)["tryon"]
    lat = np.asarray(jax.random.normal(i["rng"], (1, 16, 16, 4), jnp.float32))  # 32 px / 2
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    fused = FusedTryOn(TryOnPreprocessor(TINY_SAM), pipe)
    photos = [nchw(np.asarray(i[k])[None])[0] for k in ("subject", "clothes1", "clothes2")]
    out = fused(from_jax_params(params, device="cpu"), *photos, np.asarray(i["kps"]),
                np.asarray(i["ids"]), np.asarray(i["neg"]),
                num_inference_steps=i["num_inference_steps"], latents=nchw(lat))
    assert out.shape == (1, 3, 32, 32)
    np.testing.assert_allclose(nhwc(out), want, atol=2e-4, rtol=1e-3)


# ------------------------------------------------------------ TryOnSystem
@pytest.fixture(scope="module")
def tiny_system():
    """A TryOnSystem around the TINY SAM (fp32) and pipeline, random init
    from the port's own generator (as tests/test_tryon_e2e.py builds the
    JAX one around tiny models)."""
    sys_ = tryon.TryOnSystem.__new__(tryon.TryOnSystem)
    sys_.device = torch.device("cpu")
    sys_.use_agnostic = False
    gen = make_generator(0, "cpu")
    sys_.pose_net = BodyPoseNet()
    sys_.pose_size = 64
    sys_.pose_params = sys_.pose_net.init_params(gen, size=64)
    sys_.preproc = TryOnPreprocessor(TINY_SAM)
    sys_.sam_params = sys_.preproc.init_params(gen)
    sys_.pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    sys_.gen_params = sys_.pipe.init_params(gen)
    return sys_


def test_prepare_cond_batch_matches_sequential(tiny_system):
    """Two 32 px triples: all six photos through one pose call and one
    preprocessing call equal the per-request prepare_cond, within 2e-5 (the
    JAX test's tolerance)."""
    g = np.random.default_rng(20)
    triples = [[g.random((32, 32, 3)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    seq = [tiny_system.prepare_cond(*t) for t in triples]
    got = tiny_system.prepare_cond_batch(*zip(*triples))
    assert len(got) == 2
    for a, b in zip(got, seq):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], atol=2e-5, err_msg=k)
            assert a[k].shape == ((512, 512, 3) if k.endswith("pose") else (32, 32, 3))


def test_detect_pose_batch_matches_single(tiny_system):
    imgs = np.random.default_rng(21).random((2, 128, 128, 3)).astype(np.float32)
    kps_b, skels_b = tiny_system.detect_pose_batch(imgs)
    assert skels_b.shape == (2, 512, 512, 3)
    for j in range(2):
        kp, skel = tiny_system.detect_pose(imgs[j])
        assert (kp is None) == (kps_b[j] is None)
        if kp is not None:
            np.testing.assert_allclose(kps_b[j], kp, atol=1e-5)
        np.testing.assert_allclose(skels_b[j], skel, atol=1e-5)


def test_generate_from_cond_on_cpu(tiny_system):
    g = np.random.default_rng(22)
    cond = tiny_system.prepare_cond(*(g.random((32, 32, 3)).astype(np.float32)
                                      for _ in range(3)))
    cond = {k: v[::16, ::16] if k.endswith("pose") else v for k, v in cond.items()}
    ids = np.zeros((1, 7), np.int64)
    out = tiny_system.generate(cond, ids, ids, steps=2)
    assert out.shape == (32, 32, 3) and np.isfinite(out).all()
    assert 0 <= out.min() and out.max() <= 1


def test_load_image_512_pads_nonsquare(tmp_path):
    from PIL import Image

    p = str(tmp_path / "x.png")
    Image.fromarray(np.random.default_rng(23).integers(0, 255, (300, 600, 3),
                                                       dtype=np.uint8)).save(p)
    out = tryon.load_image_512(p)
    assert out.shape == (512, 512, 3) and out.dtype == np.uint8
    assert (out[:5] == 255).all() and (out[-5:] == 255).all()  # white bands top and bottom


REQUIRED = ["--subject", "s.png", "--clothes1", "a.png", "--clothes2", "b.png", "--random_init"]


@pytest.mark.parametrize("flags,item", [
    (["--mode", "turbo"], "item 12"), (["--controlnet_cache_interval", "2"], "item 12"),
    (["--unet_cache_interval", "3"], "item 12"), (["--controlnet_cache_steps", "0", "4"], "item 12"),
    (["--unet_cache_steps", "0", "2"], "item 12"), (["--cfg_interval", "0", "0.5"], "item 12"),
    (["--tome", "0.5"], "item 12"), (["--int8_scales", "s.json"], "item 12"),
    (["--scheduler", "dpm++"], "item 12"), (["--scheduler", "lcm"], "item 12"),
    (["--lcm_lora", "a.safetensors"], "item 14"), (["--clip_model", "clip"], "item 14"),
    (["--exported_dir", "art"], "item 15"), (["--pretrained_model", "sd"], "item 1b"),
    (["--vae", "vae"], "item 1b"), (["--openpose_controlnet", "op"], "item 1b"),
    (["--edgestyle_checkpoint", "ck"], "item 1b"),
    (["--sam_checkpoint", "sam.safetensors"], "item 1b"),
    (["--bodypose_checkpoint", "pose.safetensors"], "item 1b"),
])
def test_unported_flags_raise_naming_their_item(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        tryon.main(REQUIRED + flags, device="cpu")


def test_exact_values_of_the_knobs_are_accepted():
    args = tryon.parse_args(REQUIRED + ["--mode", "exact", "--tome", "0", "--scheduler", "unipc",
                                        "--cfg_interval", "0", "1",
                                        "--controlnet_cache_interval", "1"])
    tryon.refuse_unported(args)


def test_sam_checkpoint_layouts_load(tmp_path):
    """A full state dict, a {"state_dict"}-wrapped one and a decoder-only
    head load through torch.load(weights_only=True) and the port's mapper;
    a head without a checkpoint copies the base decoder; a pickled module
    is refused."""
    import json

    from tests import golden_mirror as gm
    from edgestyle_tpu_torch.models.efficientvit.backbone import BackboneConfig
    from edgestyle_tpu_torch.models.efficientvit.sam import SamConfig

    with open(gm.SAM_SHAPES_JSON) as f:
        sd = {k: torch.from_numpy(v) for k, v in
              gm.synth_state_dict(json.load(f)["sam_mid"]).items()}
    c = gm.SAM_MID
    pre = TryOnPreprocessor(SamConfig(backbone=BackboneConfig(width_list=tuple(c["widths"]),
                                                              depth_list=tuple(c["depths"])),
                                      neck_depth=c["neck_depth"], image_size=c["image_size"]))
    torch.save(sd, tmp_path / "base.pt")
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pth")
    dec = {k[len("mask_decoder."):]: v * 2 for k, v in sd.items() if k.startswith("mask_decoder.")}
    torch.save(dec, tmp_path / "head.pt")
    params = tryon._load_sam_params(pre, str(tmp_path / "wrapped.pth"),
                                    {"head": str(tmp_path / "head.pt")}, device="cpu")
    base = tryon._load_sam_params(pre, str(tmp_path / "base.pt"), device="cpu")
    tok = params["sam"]["mask_decoder"]["iou_token"]
    torch.testing.assert_close(base["sam"]["mask_decoder"]["iou_token"], tok)
    torch.testing.assert_close(params["decoders"]["subject"]["iou_token"], tok)
    torch.testing.assert_close(params["decoders"]["head"]["iou_token"], 2 * tok)
    assert params["sam"]["prompt_encoder"]["point_embeddings"].shape == (4, 256)
    torch.save(torch.nn.Linear(2, 2), tmp_path / "module.pt")  # a pickled module, not weights
    with pytest.raises(ValueError, match="weights-only"):
        tryon._load_sam_params(pre, str(tmp_path / "module.pt"), device="cpu")


def test_entry_points_refuse_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tryon.TryOnSystem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tryon.main(REQUIRED)

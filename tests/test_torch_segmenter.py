"""The port's segmenter finetuner (training/segmenter.py,
apps/train_segmenter.py) against the JAX package's, on the CPU in fp32 at
the TINY EfficientViT-SAM of tests/test_torch_preprocess.py (64 px, as the
JAX package's own segmenter tests run it).

JAX's params reach the port through ``from_jax_params``; the box noise JAX
draws from its keys is fed to the port's step. The JAX side is jitted once
per program. Each test states its tolerance. The fault guard at the end
holds the try-on's ``--sam_<head>`` loader to the file either package's
trainer writes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from edgestyle_tpu.apps import train_segmenter as japp
from edgestyle_tpu.apps.tryon import _load_sam_params as j_load_sam_params
from edgestyle_tpu.models.efficientvit import sam as jsam
from edgestyle_tpu.ops import morphology as jmorph
from edgestyle_tpu.pipelines.preprocess import TryOnPreprocessor as JPreprocessor
from edgestyle_tpu.training import segmenter as jseg
from edgestyle_tpu_torch.apps import train_segmenter as app
from edgestyle_tpu_torch.apps.tryon import _load_sam_params
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.core.safetensors import load_file, save_file
from edgestyle_tpu_torch.models.efficientvit.backbone import BackboneConfig
from edgestyle_tpu_torch.models.efficientvit.sam import EfficientViTSam, SamConfig
from edgestyle_tpu_torch.pipelines.preprocess import TryOnPreprocessor
from edgestyle_tpu_torch.training import segmenter as seg
from tests import golden_mirror as gm
from tests.test_efficientvit import TINY_BB as J_TINY_BB
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

SIZE = 64
TINY_BB = BackboneConfig(width_list=(8, 16, 32, 64, 96), depth_list=(1, 1, 1, 1, 1), qkv_dim=8)
TINY_SAM = SamConfig(backbone=TINY_BB, neck_depth=1, image_size=SIZE)
J_TINY_SAM = jsam.SamConfig(backbone=J_TINY_BB, neck_depth=1, image_size=SIZE)
PROMPT_SCALE = TINY_SAM.prompt_input_size / SIZE
LOSS_RTOL = 1e-5   # one step's loss, relative
GRAD_TOL = 1e-4    # each decoder gradient leaf, of its largest |value|
LEAF_TOL = 1e-4    # each decoder leaf after 3 steps, of its largest |value|
# A leaf that starts at zero (the decoder's Dense biases) holds only its
# three Prodigy updates after 3 steps, each m / (sqrt(v) + d eps): a ratio
# that makes the small gradient entries as large as the big ones, so the
# two packages' roundoff in those entries shows at full size. Measured:
# 2.3e-4 of the leaf's largest |value| (out_proj biases).
ZERO_INIT_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def no_persistent_compile_cache():
    """Keep this module's JAX programs out of the persistent compilation
    cache, which importing ``__graft_entry__`` turns on for a whole worker:
    XLA:CPU's cache writes and reads segfault now and then
    (edgestyle_tpu/core/cache.py:15-20), and these programs gain nothing
    from it."""
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", before)


def jnp_np(tree):
    return jax.tree.map(np.asarray, tree)


def leaf_err(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want| (1 where want is all zeros)."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(got.detach().float().numpy() - want).max()) / scale


def is_roundoff(path) -> bool:
    """The attention's key-projection biases: a softmax over the keys does
    not change when one constant joins every logit of a row, and q . b_k is
    such a constant, so their exact gradient is 0 and both packages compute
    roundoff. Each is held to the largest |value| of the whole tree."""
    return path[-2:] == ("k_proj", "bias")


def tree_errs(got: dict, want: dict) -> dict:
    """{dotted path: leaf_err} over two flat trees of the same keys; a
    roundoff leaf (:func:`is_roundoff`) is scaled by the tree's largest
    |value| instead of its own."""
    assert got.keys() == want.keys()
    top = max(float(v.abs().max()) for v in want.values())
    errs = {}
    for k, w in want.items():
        d = float((got[k].detach().float() - w).abs().max())
        scale = top if is_roundoff(k) else (float(w.abs().max()) or 1.0)
        errs[".".join(k)] = d / scale
    return errs


def jax_noise(key, b: int, jitter: int) -> np.ndarray:
    """The (B, 4) box noise JAX's step draws from ``key``."""
    keys = jax.random.split(key, b)
    return np.asarray(jax.vmap(lambda r: jax.random.randint(r, (4,), -jitter, jitter + 1))(keys))


@pytest.fixture(scope="module")
def sams():
    """JAX's TINY SAM, the port's seeded init moved to the JAX layout
    (``to_jax_params``, which saves JAX's own init and its compile) and the
    port's copy of those JAX params."""
    tp = EfficientViTSam(TINY_SAM).init_params(make_generator(0, "cpu"))
    jp = to_jax_params(tp)
    return jsam.EfficientViTSam(J_TINY_SAM), jp, from_jax_params(jp, device="cpu")


def make_batch(seed: int):
    """Two SAM-normalised images and parsing labels: example 0 has hair
    (2), a face (3) and clothes (5); example 1 only clothes (4), so its
    "head" target is empty."""
    g = np.random.default_rng(seed)
    image = g.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((2, SIZE, SIZE), np.int32)
    labels[0, 6:16, 20:44] = 2
    labels[0, 16:26, 24:40] = 3
    labels[0, 28:58, 14:50] = 5
    labels[1, 20:54, 10:40] = 4
    return image, labels


def port_batch(image, labels):
    return {"image": torch.from_numpy(image).permute(0, 3, 1, 2).contiguous(),
            "labels": torch.from_numpy(labels)}


# ---------------------------------------------------------------- pieces
@pytest.mark.parametrize("head", sorted(seg.KEEP_CATEGORIES))
def test_binary_target_matches_jax(head):
    """Every label 0-19 for each head: bit-equal."""
    labels = np.random.default_rng(3).integers(0, 20, (2, 9, 11)).astype(np.int32)
    want = np.asarray(jseg.binary_target(jnp.asarray(labels), head))
    got = seg.binary_target(torch.from_numpy(labels), head).numpy()
    np.testing.assert_array_equal(got, want)


def test_dice_ce_loss_matches_jax():
    """Random logits (some large, either sign) against a random target:
    within 1e-6, and the same on a perfect and a wrong prediction."""
    g = np.random.default_rng(4)
    t = g.random((3, 16, 16)) > 0.5
    for logits in (g.standard_normal((3, 16, 16)).astype(np.float32) * 4,
                   np.where(t, 20.0, -20.0).astype(np.float32),
                   np.where(t, -20.0, 20.0).astype(np.float32)):
        want = float(jseg.dice_ce_loss(jnp.asarray(logits), jnp.asarray(t)))
        got = float(seg.dice_ce_loss(torch.from_numpy(logits), torch.from_numpy(t)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("jitter", [0, 5, 30])
def test_jittered_box_matches_jax_given_its_noise(jitter):
    """Boxes from JAX's keys, the noise fed to the port: points and labels
    within 1e-6 (they are equal), an empty mask included (JAX's zero box,
    jittered and clipped)."""
    m = np.zeros((3, SIZE, SIZE), bool)
    m[0, 20:40, 10:30] = True
    m[1, 0:5, 60:64] = True  # at the border: the clip bites
    keys = jax.random.split(jax.random.key(jitter), 3)
    want_p, want_l = jax.vmap(lambda mm, r: jseg.jittered_box(mm, r, jitter, PROMPT_SCALE))(
        jnp.asarray(m), keys)
    noise = np.stack([np.asarray(jax.random.randint(r, (4,), -jitter, jitter + 1)) for r in keys])
    pts, lbl = seg.jittered_box(torch.from_numpy(m), torch.from_numpy(noise), PROMPT_SCALE)
    np.testing.assert_allclose(pts.numpy(), np.asarray(want_p), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(want_l))


def jax_loss_fn(sam, cfg):
    """JAX's segmenter loss (edgestyle_tpu/training/segmenter.py:95-118),
    composed from the package's own functions, as a function of the
    decoder."""
    def loss(decoder, frozen, image, labels, rng):
        b, h, w, _ = image.shape
        target = jseg.binary_target(labels, cfg.head)
        target = jax.vmap(lambda m: jmorph.smooth_mask(m, 3, 1))(target)
        emb = jax.lax.stop_gradient(sam.apply({"params": frozen}, image, method="encode_image"))
        pts, lbls = jax.vmap(lambda m, r: jseg.jittered_box(m, r, cfg.box_jitter, PROMPT_SCALE))(
            target, jax.random.split(rng, b))
        masks, _ = sam.apply({"params": {**frozen, "mask_decoder": decoder}}, emb, pts, lbls,
                             method="decode", multimask_output=False)
        logits = jsam.postprocess_masks(masks.astype(jnp.float32), (h, w))[:, 0]
        return jseg.dice_ce_loss(logits, target)

    return loss


def test_one_step_loss_and_gradients_match_jax(sams):
    """Head "head" with one example's target empty, jitter 30, JAX's noise
    fed in: the loss within LOSS_RTOL relative and every decoder gradient
    leaf within GRAD_TOL of its largest |value|; no gradient reaches the
    frozen encoder."""
    sam, jp, tp = sams
    cfg = jseg.SegmenterTrainConfig(head="head", box_jitter=30)
    image, labels = make_batch(5)
    key = jax.random.key(11)
    want_loss, want_g = jax.jit(jax.value_and_grad(jax_loss_fn(sam, cfg)))(
        jp["mask_decoder"], jp, jnp.asarray(image), jnp.asarray(labels), key)
    tcfg = seg.SegmenterTrainConfig(head="head", box_jitter=30)
    tsam = EfficientViTSam(TINY_SAM)
    loss, grads = seg.segmenter_grads(tsam, tcfg, tp["mask_decoder"], tp,
                                      port_batch(image, labels),
                                      torch.from_numpy(jax_noise(key, 2, 30)))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    errs = tree_errs(flatten(grads), flatten(from_jax_params(jnp_np(want_g), device="cpu")))
    assert max(errs.values()) <= GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert all(v.grad is None and not v.requires_grad for v in flatten(tp).values())


def test_three_train_steps_match_jax(sams):
    """JAX's jitted train step and the port's, head "clothes", three steps
    on JAX's keys: each step's loss within LOSS_RTOL relative, the decoder
    leaves within LEAF_TOL of their largest |value|, Prodigy's d within
    1e-4 relative; the frozen params are untouched."""
    sam, jp, tp = sams
    jcfg = jseg.SegmenterTrainConfig(head="clothes", box_jitter=10)
    jstate = jseg.init_segmenter_state(jp, jcfg)
    jstep = jax.jit(jseg.make_segmenter_train_step(sam, jcfg))
    tcfg = seg.SegmenterTrainConfig(head="clothes", box_jitter=10)
    step = seg.make_segmenter_train_step(EfficientViTSam(TINY_SAM), tcfg)
    state = seg.init_segmenter_state(tp, tcfg)
    before = {k: v.clone() for k, v in flatten(tp).items()}
    image, labels = make_batch(6)
    jbatch = {"image": jnp.asarray(image), "labels": jnp.asarray(labels)}
    for i in range(3):
        key = jax.random.key(100 + i)
        jstate, jm = jstep(jstate, jp, jbatch, key)
        state, m = step(state, tp, port_batch(image, labels),
                        torch.from_numpy(jax_noise(key, 2, 10)))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"])), i
    assert state["step"] == int(jstate["step"]) == 3
    got, init = flatten(state["decoder"]), flatten(tp["mask_decoder"])
    errs = tree_errs(got, flatten(from_jax_params(jnp_np(jstate["decoder"]), device="cpu")))
    zero = {".".join(k) for k, v in init.items() if not v.any()}
    bad = {k: e for k, e in errs.items() if e > (ZERO_INIT_TOL if k in zero else LEAF_TOL)}
    assert not bad, bad
    jd = float(jstate["opt_state"].d)
    assert abs(float(state["opt_state"]["d"]) - jd) <= 1e-4 * jd
    assert all(torch.equal(v, before[k]) for k, v in flatten(tp).items())
    # only the first mask token's hypernetwork and nothing of the IoU head
    # reach a single-mask loss: those leaves alone stay where they were
    still = {k[0] for k, v in got.items() if torch.equal(v, init[k])}
    assert still == {"iou_mlp", "hyper_mlps_1", "hyper_mlps_2", "hyper_mlps_3"}, still


# ------------------------------------------------------------ the CLI
def write_parsing_dir(root, n: int = 5):
    """tests/test_train_segmenter.py's folder: non-square JPEG photos and
    PNG parsing labels (clothes 5, hair 2)."""
    g = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "masks"))
    for i in range(n):
        img = g.integers(0, 255, (48, 40, 3), dtype=np.uint8)
        lab = np.zeros((48, 40), np.uint8)
        lab[10:30, 8:30] = 5
        lab[4:10, 14:26] = 2
        Image.fromarray(img).save(os.path.join(root, "images", f"f{i}.jpg"))
        Image.fromarray(lab).save(os.path.join(root, "masks", f"f{i}.png"))
    return root


def tiny_sam_checkpoint(path) -> str:
    """A seeded upstream-keyed state dict of the TINY SAM (tests/
    torch_sam.py's module names), which both packages' mappers read."""
    from tests.torch_sam import EfficientViTSamT

    mod = EfficientViTSamT(TINY_BB.width_list, TINY_BB.depth_list, 1, TINY_BB.qkv_dim)
    shapes = {k: list(v.shape) for k, v in mod.state_dict().items()}
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          gm.synth_state_dict(shapes, seed=15).items()}
    save_file(sd, path)
    return path


def test_load_parsing_folder_and_overlay_grid_bit_equal(tmp_path):
    root = write_parsing_dir(str(tmp_path / "parsing"))
    got, want = app.load_parsing_folder(root, SIZE), japp.load_parsing_folder(root, SIZE)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    g = np.random.default_rng(1)
    imgs = g.random((3, 16, 16, 3)).astype(np.float32)
    t, p = g.random((3, 16, 16)) > 0.5, g.random((3, 16, 16)) > 0.3
    assert np.array_equal(app.overlay_grid(imgs, t, p), japp.overlay_grid(imgs, t, p))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' ``main`` on one parsing folder and one TINY
    checkpoint file, ``--box_jitter 0``: (JSON lines of each, output dirs,
    checkpoint path, the port's final state)."""
    pytest.importorskip("safetensors")  # the JAX package's reader
    root = tmp_path_factory.mktemp("seg")
    parsing = write_parsing_dir(str(root / "parsing"))
    ckpt = tiny_sam_checkpoint(str(root / "sam_tiny.safetensors"))
    argv = ["--head", "clothes", "--dataset_dir", parsing, "--sam_checkpoint", ckpt,
            "--epochs", "2", "--batch_size", "2", "--max_steps", "4", "--box_jitter", "0",
            "--overlay_samples", "2"]
    lines = {}
    import contextlib
    import io

    for name, run in (("jax", lambda out: japp.main(argv + ["--output_dir", out],
                                                     sam_cfg=J_TINY_SAM)),
                      ("port", lambda out: app.main(argv + ["--output_dir", out],
                                                    sam_cfg=TINY_SAM, device="cpu"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = run(str(root / name))
        lines[name] = [json.loads(ln) for ln in buf.getvalue().splitlines()
                       if ln.startswith("{")]
        if name == "port":
            state, frozen = result
    return lines, {n: str(root / n) for n in ("jax", "port")}, ckpt, state, frozen


def test_train_segmenter_main_matches_jax(trained):
    """The same JSON lines (train/val counts, epochs, steps; losses within
    1e-4 after both round to 4 places) and an exported decoder with JAX's
    keys and shapes, each value within 1e-4 of its leaf's largest; the
    overlays went to TensorBoard where tensorboardX is installed."""
    lines, outs, _, _, _ = trained
    assert len(lines["port"]) == len(lines["jax"]) == 4
    for got, want in zip(lines["port"], lines["jax"]):
        assert got.keys() == want.keys()
        for k in got:
            if k in ("train_loss", "best_loss"):
                assert abs(got[k] - want[k]) <= 1.01e-4, (k, got[k], want[k])
            elif k != "elapsed_s":
                assert got[k] == want[k], k
    name = "trained_decoder_clothes.safetensors"
    from safetensors.numpy import load_file as np_load

    want, got = np_load(os.path.join(outs["jax"], name)), np_load(os.path.join(outs["port"], name))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        assert leaf_err(torch.from_numpy(got[k]), want[k]) <= LEAF_TOL, k
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        return
    assert os.listdir(os.path.join(outs["port"], "logs"))


def test_trained_decoder_files_load_through_the_port_but_not_jax(trained, tmp_path):
    """The JAX trainer's fault, not copied: its file (Flax names) loads
    through the port's ``_load_sam_params`` (the port's own file bit-equal
    to the trained decoder, JAX's to JAX's leaves carried across), while the
    JAX package's own loader raises on it. A torch-layout decoder-only file
    still loads as before."""
    _, outs, ckpt, state, frozen = trained
    name = "trained_decoder_clothes.safetensors"
    pre = TryOnPreprocessor(TINY_SAM)
    port_file, jax_file = (os.path.join(outs[n], name) for n in ("port", "jax"))
    loaded = _load_sam_params(pre, ckpt, {"clothes": port_file, "head": jax_file}, device="cpu")
    got, want = flatten(loaded["decoders"]["clothes"]), flatten(state["decoder"])
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    jfile = {tuple(k.split(".")): v.numpy() for k, v in load_file(jax_file).items()}
    from edgestyle_tpu_torch.core.params import unflatten

    want_j = flatten(from_jax_params(unflatten(jfile), device="cpu"))
    got_j = flatten(loaded["decoders"]["head"])
    assert got_j.keys() == want_j.keys()
    assert all(torch.equal(got_j[k], want_j[k]) for k in want_j)
    base = flatten(frozen["mask_decoder"])
    assert all(torch.equal(v, base[k]) for k, v in flatten(loaded["decoders"]["subject"]).items())
    # torch's own decoder-only layout
    sd = load_file(ckpt)
    dec_only = str(tmp_path / "decoder.safetensors")
    save_file({k[len("mask_decoder."):]: v for k, v in sd.items()
               if k.startswith("mask_decoder.")}, dec_only)
    again = _load_sam_params(pre, ckpt, {"agnostic": dec_only}, device="cpu")
    assert all(torch.equal(v, base[k])
               for k, v in flatten(again["decoders"]["agnostic"]).items())
    with pytest.raises(KeyError, match="unported torch keys"):
        j_load_sam_params(JPreprocessor(J_TINY_SAM), ckpt, {"clothes": jax_file})


def test_parse_args_matches_jax():
    """Every flag's default, and the four heads."""
    assert vars(app.parse_args([])) == vars(japp.parse_args([]))
    for h in ("subject", "head", "clothes", "body"):
        assert app.parse_args(["--head", h]).head == h

"""The port's dataset builder against the JAX package's, on the CPU in fp32:
SAM's automatic masks (models/efficientvit/sam.py) at the TINY SAM, the
extractor (apps/extract_dataset.py) on stub systems, the curation tools and
CLIP-IQA (data/curation.py) on the TINY CLIP of
tests/test_torch_clip_vision.py, and the hub rows (data/hub.py).

The same numpy inputs, made from seeds, go through both packages; JAX's
params come from the port's seeded init moved across with
``to_jax_params``. Each test states its tolerance.
"""

import filecmp
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from edgestyle_tpu.apps import extract_dataset as jed
from edgestyle_tpu.data import curation as jcur
from edgestyle_tpu.data import hub as jhub
from edgestyle_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from edgestyle_tpu.models import clip_vision as jclip_vision
from edgestyle_tpu.models.efficientvit import sam as jsam
from edgestyle_tpu_torch.apps import extract_dataset as ed
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.core.safetensors import save_file
from edgestyle_tpu_torch.data import curation as cur
from edgestyle_tpu_torch.data import hub
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig
from edgestyle_tpu_torch.models.clip_vision import CLIPVisionConfig
from edgestyle_tpu_torch.models.efficientvit import sam
from edgestyle_tpu_torch.models.efficientvit.backbone import BackboneConfig
from tests.test_efficientvit import TINY_BB as J_TINY_BB
from tests.test_torch_segmenter import no_persistent_compile_cache  # noqa: F401 (autouse)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

SIZE = 64
TINY_BB = BackboneConfig(width_list=(8, 16, 32, 64, 96), depth_list=(1, 1, 1, 1, 1), qkv_dim=8)
TINY_SAM = sam.SamConfig(backbone=TINY_BB, neck_depth=1, image_size=SIZE)
J_TINY_SAM = jsam.SamConfig(backbone=J_TINY_BB, neck_depth=1, image_size=SIZE)
PPS, CHUNK = 4, 8  # 16 grid points in two chunks
SCORE_TOL = 1e-5   # predicted IoU and stability
LOGIT_EDGE = 1e-5  # a mask pixel may differ only where JAX's logit is this close to 0


@pytest.fixture(scope="module")
def sams():
    """(JAX module, JAX params, port module, port params, image (1, S, S, 3)
    SAM-normalised): the port's seeded init, moved to JAX."""
    tp = sam.EfficientViTSam(TINY_SAM).init_params(make_generator(0, "cpu"))
    jp = to_jax_params(tp)
    img = np.random.default_rng(1).standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    return (jsam.EfficientViTSam(J_TINY_SAM), jp, sam.EfficientViTSam(TINY_SAM),
            from_jax_params(jp, device="cpu"), img)


def test_point_grid_and_stability_score_match_jax():
    """The grid bit-equal at three sizes; stability on random logits (one
    exactly at +-1, the thresholds' edges) bit-equal."""
    for n in (1, 4, 16):
        np.testing.assert_array_equal(sam.build_point_grid(n).numpy(),
                                      np.asarray(jsam.build_point_grid(n)))
    x = np.random.default_rng(2).standard_normal((3, 2, 32, 32)).astype(np.float32) * 2
    x[0, 0, :4, :4] = 1.0
    x[0, 1, :4, :4] = -1.0
    x[2, 1] = -5.0  # an empty loose mask: union clamped to 1
    np.testing.assert_array_equal(sam.stability_score(torch.from_numpy(x)).numpy(),
                                  np.asarray(jsam.stability_score(jnp.asarray(x))))


@pytest.fixture(scope="module")
def candidates(sams):
    """JAX's candidates and every grid point's three mask logits (one jitted
    program), and the port's candidates."""
    jmod, jp, tmod, tp, img = sams

    @jax.jit
    def run(p, im):
        v = {"params": p}
        cand = jsam.automatic_mask_candidates(jmod, v, im, points_per_side=PPS, chunk=CHUNK)
        emb = jmod.apply(v, im, method=jmod.encode_image)
        pts = jsam.build_point_grid(PPS)
        n = pts.shape[0]
        logits, _ = jmod.apply(v, jnp.broadcast_to(emb, (n,) + emb.shape[1:]), pts,
                               jnp.ones((n, 1), jnp.int32), True, method=jmod.decode)
        return cand, logits.reshape(-1, *logits.shape[-2:])

    (jm, jiou, jstab), jlogits = jax.tree.map(np.asarray, run(jp, jnp.asarray(img)))
    got = sam.automatic_mask_candidates(tmod, tp, torch.from_numpy(img).permute(0, 3, 1, 2),
                                        points_per_side=PPS, chunk=CHUNK)
    return (jm, jiou, jstab, jlogits), tuple(t.numpy() for t in got)


def test_automatic_mask_candidates_match_jax(candidates):
    """16 points x 3 masks: predicted IoU within SCORE_TOL; the bool masks
    equal except where JAX's logit is within LOGIT_EDGE of 0; stability, a
    ratio of pixel counts at logit thresholds +-1, within SCORE_TOL plus one
    count (1 / the loose mask's area) for each pixel whose JAX logit is
    within LOGIT_EDGE of +-1 (measured: one such pixel moved one mask's
    stability by 1.9e-5 = 1 / 53,526)."""
    (jm, jiou, jstab, jlogits), (m, iou, stab) = candidates
    assert m.shape == jm.shape == (PPS * PPS * 3, 256, 256) and m.dtype == bool
    assert np.abs(iou - jiou).max() <= SCORE_TOL
    edge = (np.abs(np.abs(jlogits) - 1.0) <= LOGIT_EDGE).sum(axis=(1, 2))
    loose = np.maximum((jlogits > -1.0).sum(axis=(1, 2)) - edge, 1)
    assert (np.abs(stab - jstab) <= SCORE_TOL + edge / loose).all()
    differ = m != jm
    assert not (differ & (np.abs(jlogits) > LOGIT_EDGE)).any()
    assert 0 < jm.mean() < 1  # non-degenerate masks


def test_candidate_chunk_must_divide_the_grid(sams):
    """9 grid points in chunks of 4 raise, as JAX's program does."""
    _, _, tmod, tp, img = sams
    with pytest.raises(ValueError, match="not divisible"):
        sam.automatic_mask_candidates(tmod, tp, torch.from_numpy(img).permute(0, 3, 1, 2),
                                      points_per_side=3, chunk=4)


@pytest.mark.parametrize("iou_q,stab_q,nms", [(0.25, 0.0, 0.7), (0.5, 0.5, 0.3),
                                               (0.0, 0.0, 0.9)])
def test_select_auto_masks_bit_equal(candidates, iou_q, stab_q, nms):
    """JAX's candidates through both packages' host tail, the thresholds at
    quantiles of the predicted IoU and the stability (random weights score
    low): the same kept masks in the same order, bit for bit."""
    (jm, jiou, jstab, _), _ = candidates
    kw = dict(pred_iou_thresh=float(np.quantile(jiou, iou_q)),
              stability_thresh=float(np.quantile(jstab, stab_q)), nms_iou=nms)
    got = sam.select_auto_masks(torch.from_numpy(jm), torch.from_numpy(jiou),
                                torch.from_numpy(jstab), **kw)
    want = jsam.select_auto_masks(jm, jiou, jstab, **kw)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert np.array_equal(a["segmentation"], b["segmentation"])
        assert a["predicted_iou"] == b["predicted_iou"]
        assert a["stability_score"] == b["stability_score"]


class _Preproc:
    def __init__(self, module):
        self.sam = module


def test_person_box_from_auto_masks_matches_jax(sams):
    """The pose-less person box at TINY, thresholds opened as
    tests/test_serve_extract.py opens them: the same box within 1e-4 px, or
    None in both; closed thresholds give None."""
    jmod, jp, tmod, tp, _ = sams
    img01 = np.random.default_rng(3).random((SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(points_per_side=2, chunk=4, pred_iou_thresh=-10.0, stability_thresh=0.0,
              area_frac=(0.0, 1.0))
    want = jed.person_box_from_auto_masks(_Preproc(jmod), {"sam": jp}, img01, **kw)
    got = ed.person_box_from_auto_masks(_Preproc(tmod), {"sam": tp}, img01, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == np.float32 and got.shape == (4,)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        assert 0 <= got[0] <= got[2] <= SIZE and 0 <= got[1] <= got[3] <= SIZE
    closed = dict(kw, pred_iou_thresh=10.0)
    assert ed.person_box_from_auto_masks(_Preproc(tmod), {"sam": tp}, img01, **closed) is None


def test_pose_box_and_crop_match_jax():
    """person_box_from_pose and margin_crop_square bit-equal."""
    g = np.random.default_rng(4)
    kp = np.full((18, 2), np.nan, np.float32)
    kp[[0, 2, 5, 8, 11]] = g.uniform(40, 470, (5, 2))
    img = g.integers(0, 255, (512, 512, 3), dtype=np.uint8)
    box = ed.person_box_from_pose(kp)
    np.testing.assert_array_equal(box, jed.person_box_from_pose(kp))
    np.testing.assert_array_equal(ed.margin_crop_square(img, box),
                                  jed.margin_crop_square(img, box))
    assert ed.person_box_from_pose(np.full((18, 2), np.nan)) is None


# ------------------------------------------------------------ extraction
class StubSystem:
    """tests/test_serve_extract.py's stub: a pose on every call but those
    in ``fail_pose`` (1-based), composites from the crop; ``scores`` gives
    each extract() call a subject score."""

    def __init__(self, scores=None, fail_pose=()):
        self.scores = list(scores) if scores is not None else None
        self.fail_pose = set(fail_pose)
        self.pose_calls = 0

    def detect_pose(self, img01):
        self.pose_calls += 1
        if self.pose_calls in self.fail_pose:
            return None, np.zeros((512, 512, 3), np.float32)
        kp = np.full((18, 2), np.nan, np.float32)
        kp[[0, 2, 5, 8, 11]] = [[256, 100], [200, 180], [300, 180], [220, 300], [290, 300]]
        return kp, np.full((512, 512, 3), 0.25, np.float32)

    def extract(self, img01, kp):
        g = {"subject": img01, "agnostic": np.where(img01 > 0.5, img01, 127 / 255),
             "head": img01 * 0.5, "clothes": img01 * 0.9}
        if self.scores is not None:
            g["subject_score"] = self.scores.pop(0)
        return g


class NoPose(StubSystem):
    def detect_pose(self, img01):
        return None, np.zeros((512, 512, 3), np.float32)


class WithSam(StubSystem):
    preproc = object()  # the fallback's machinery is there
    sam_params = object()


class Iqa:
    """Favours brighter subject composites; takes either package's array."""

    def __call__(self, img):
        return np.asarray([float(np.asarray(img).mean())])


def same_trees(a: str, b: str) -> bool:
    """The same files under both roots, byte for byte."""
    def files(r):
        return sorted(os.path.relpath(os.path.join(d, f), r)
                      for d, _, fs in os.walk(r) for f in fs)

    fa, fb = files(a), files(b)
    return fa == fb and all(filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False)
                            for f in fa)


CASES = {
    "plain": dict(make=lambda: StubSystem()),
    "score_gate_ranking": dict(make=lambda: StubSystem([0.2, 0.9, 0.8, 0.7]), top_k=2),
    "score_gate_ranking_iqa": dict(make=lambda: StubSystem([0.2, 0.9, 0.8, 0.7]), top_k=2,
                                   iqa=Iqa()),
    "no_ranking_signal": dict(make=lambda: StubSystem(), top_k=2),
    "iqa_only": dict(make=lambda: StubSystem(), top_k=2, iqa=Iqa()),
    "fallback": dict(make=lambda: WithSam(fail_pose=(3,)), box=True),
    "fallback_no_box": dict(make=lambda: WithSam(fail_pose=(1, 5)), box=False),
    "no_pose_no_sam": dict(make=lambda: NoPose()),
    "no_pose_on_crop": dict(make=lambda: StubSystem(fail_pose=(2,))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_subject_matches_jax(case, tmp_path, monkeypatch):
    """Four frames through both packages' extract_subject with the same
    stub system: byte-identical files and equal stats and counts. The
    pose-less fallback's box is stubbed in both (a box, or None)."""
    c = CASES[case]
    if "box" in c:
        box = np.array([100, 50, 400, 480], np.float32) if c["box"] else None
        for mod in (ed, jed):
            monkeypatch.setattr(mod, "person_box_from_auto_masks",
                                lambda preproc, params, img01, **kw: box)
    g = np.random.default_rng(5)
    frames = [g.integers(0, 255, (600, 400, 3), dtype=np.uint8) for _ in range(4)]
    out, stats = {}, {}
    for name, mod in (("port", ed), ("jax", jed)):
        stats[name] = {}
        out[name] = mod.extract_subject(c["make"](), frames, str(tmp_path / name),
                                        top_k=c.get("top_k"), iqa=c.get("iqa"),
                                        stats=stats[name])
    assert out["port"] == out["jax"] and stats["port"] == stats["jax"]
    assert same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    if case == "plain":
        assert out["port"] == 4
        (tmp_path / "skip").mkdir()
        (tmp_path / "skip" / "_skip_").touch()
        assert ed.extract_subject(StubSystem(), frames, str(tmp_path / "skip")) == 0


def test_load_frames_matches_jax(tmp_path):
    g = np.random.default_rng(6)
    for i in range(5):
        Image.fromarray(g.integers(0, 255, (24, 20, 3), dtype=np.uint8)).save(
            tmp_path / f"f{i}.png")
    for every in (1, 2):
        got, want = ed.load_frames(str(tmp_path), every), jed.load_frames(str(tmp_path), every)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_extract_main_flags_and_stats(tmp_path, monkeypatch, capsys):
    """main's flags (the try-on's model-source flags among them) reach
    TryOnSystem, and its JSON stats line accounts for every frame;
    TryOnSystem is stubbed."""
    g = np.random.default_rng(7)
    for i in range(3):
        Image.fromarray(g.integers(0, 255, (80, 60, 3), dtype=np.uint8)).save(
            tmp_path / f"f{i}.png")
    built = {}

    def system(random_init, args, device):
        built.update(random_init=random_init, device=device, sam=args.sam_clothes)
        return StubSystem()

    monkeypatch.setattr("edgestyle_tpu_torch.apps.tryon.TryOnSystem", system)
    line = ed.main(["--input", str(tmp_path), "--output_dir", str(tmp_path / "out"),
                    "--every_n", "1", "--random_init", "--sam_clothes", "c.safetensors"],
                   device="cpu")
    assert built == {"random_init": True, "device": "cpu", "sam": "c.safetensors"}
    assert line["frames_in"] == 3 and line["frames_written"] == 3
    assert line["box_from_pose"] == 3
    assert capsys.readouterr().out.strip().startswith('{"frames_in": 3')


# ------------------------------------------------------------ curation
@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """One TINY CLIPModel file and the byte tokenizer's files, read by both
    packages."""
    pytest.importorskip("safetensors")  # the JAX package's reader
    from tests.test_torch_clip_vision import TOK, clip_model_file

    root = tmp_path_factory.mktemp("clip")
    tok_dir = root / "tok"
    TOK.save_pretrained(str(tok_dir))
    return str(tok_dir), clip_model_file(root)


@torch.no_grad()
def test_clip_iqa_matches_jax(clip_files, tmp_path):
    """CLIP-IQA on the TINY towers from one file, the extraction's and the
    triage's prompt pairs: scores within 1e-5 of JAX's; find_bad_examples
    ranks four image files alike, scores within 1e-5."""
    from edgestyle_tpu.core import pretrained as jpretrained
    from tests.test_torch_clip_vision import TINY_TEXT, TINY_VISION, jax_encoders

    tok_dir, path = clip_files
    jp = jax.tree.map(np.asarray, jpretrained.load_clip_model_params(
        path, TINY_TEXT["num_layers"], TINY_VISION["num_layers"]))
    enc_text, enc_px = jax_encoders(jp)

    def jenc_img(x):
        return enc_px(jclip_vision.clip_preprocess(x))

    jtok = JTokenizer.from_pretrained_dir(tok_dir)
    tok, enc_img, enc_txt = cur._clip_encoders(tok_dir, path, "cpu",
                                               text_cfg=CLIPTextConfig(**TINY_TEXT),
                                               vision_cfg=CLIPVisionConfig(**TINY_VISION))
    imgs = np.random.default_rng(8).random((3, 96, 80, 3)).astype(np.float32)
    for pairs in (cur.EXTRACTION_PROMPT_PAIRS, cur.BAD_EXAMPLE_PROMPT_PAIRS):
        want = jcur.ClipIQA(jtok, jenc_img, enc_text, pairs)(jnp.asarray(imgs))
        got = cur.ClipIQA(tok, enc_img, enc_txt, pairs)(torch.from_numpy(imgs))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    paths = []
    for i, im in enumerate(np.random.default_rng(9).integers(0, 255, (4, 40, 40, 3),
                                                                dtype=np.uint8)):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(im).save(paths[-1])

    def load(p):
        return cur._load01(p, 224)

    got = cur.find_bad_examples(paths, cur.ClipIQA(tok, enc_img, enc_txt), load, worst_k=3,
                                batch_size=3)
    want = jcur.find_bad_examples(paths, jcur.ClipIQA(jtok, jenc_img, enc_text), load,
                                  worst_k=3, batch_size=3)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert max(abs(a - b) for (_, a), (_, b) in zip(got, want)) <= 1e-5


@torch.no_grad()
def test_curation_clip_subcommands_match_jax(clip_files, tmp_path, monkeypatch, capsys):
    """``bad`` (default and generic pairs) and ``similar`` on one tree, both
    packages' CLIP encoders on the TINY towers from one file: the same
    paths and pairs in the same order, scores within 1e-4 (printed to 4
    places)."""
    from edgestyle_tpu.core import pretrained as jpretrained
    from tests.test_torch_clip_vision import TINY_TEXT, TINY_VISION, jax_encoders

    tok_dir, path = clip_files
    jp = jax.tree.map(np.asarray, jpretrained.load_clip_model_params(
        path, TINY_TEXT["num_layers"], TINY_VISION["num_layers"]))
    enc_text, enc_px = jax_encoders(jp)
    jtok = JTokenizer.from_pretrained_dir(tok_dir)
    monkeypatch.setattr(jcur, "_clip_encoders", lambda t, c: (
        jtok, lambda x: enc_px(jclip_vision.clip_preprocess(x)), enc_text))
    port_encoders = cur._clip_encoders
    monkeypatch.setattr(cur, "_clip_encoders", lambda t, c, device: port_encoders(
        t, c, device, text_cfg=CLIPTextConfig(**TINY_TEXT),
        vision_cfg=CLIPVisionConfig(**TINY_VISION)))
    root = make_tree(str(tmp_path / "tree"), ())
    clip = ["--tokenizer_dir", tok_dir, "--clip_model", path]
    for argv in (["bad", root, *clip, "--worst_k", "5"],
                 ["bad", root, *clip, "--pairs", "generic"],
                 ["similar", root, *clip, "--threshold", "-1", "--per_subject", "2"]):
        outs = []
        for main in (lambda a: cur.main(a, device="cpu"), jcur.main):
            capsys.readouterr()
            main(argv)
            outs.append([ln.split() for ln in capsys.readouterr().out.splitlines()])
        got, want = outs
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a[1:] == b[1:] and abs(float(a[0]) - float(b[0])) <= 1e-4, (a, b)


def test_similar_subjects_and_compare_param_trees_match_jax():
    g = np.random.default_rng(10)
    base = g.standard_normal(16)
    embs = {"a": base, "b": base + 0.01 * g.standard_normal(16), "c": g.standard_normal(16),
            "d": -base}
    assert cur.find_similar_subjects(embs, 0.5) == jcur.find_similar_subjects(embs, 0.5)
    a = {"x": {"k": np.ones((2, 3), np.float32)}, "y": np.zeros(3, np.float32),
         "z": np.ones(2, np.float32)}
    b = {"x": {"k": np.ones((2, 3), np.float32) * 1.5}, "y": np.zeros(4, np.float32),
         "w": np.ones(1, np.float32)}
    want = jcur.compare_param_trees(a, b)
    tb = {"x": {"k": torch.ones(2, 3) * 1.5}, "y": torch.zeros(4), "w": torch.ones(1)}
    assert cur.compare_param_trees(a, tb) == want
    assert cur.compare_param_trees(a, a) == [] == jcur.compare_param_trees(a, a)


ARTS = ("processed", "openpose", "subject", "agnostic", "head", "clothes")


HOLES = (("s1", "head", "f1"), ("s2", "openpose", "f2"), ("s2", "clothes", "f2"))


def make_tree(root, holes=HOLES):
    """Two subjects x three frames x the six artifacts (64 px JPEGs), with
    ``holes`` (by default s1/f1 lacks its head, s2/f2 its openpose and
    clothes) and an empty nested directory."""
    g = np.random.default_rng(11)
    for s in ("s1", "s2"):
        for a in ARTS:
            os.makedirs(os.path.join(root, s, a))
            for f in ("f0", "f1", "f2"):
                if (s, a, f) in holes:
                    continue
                Image.fromarray(g.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
                    os.path.join(root, s, a, f + ".jpg"))
    os.makedirs(os.path.join(root, "empty", "deeper"))
    return root


@pytest.mark.parametrize("argv", [["missing"], ["clean"], ["empty-dirs"],
                                  ["empty-dirs", "--remove"], ["merge", "s1", "s2"],
                                  ["inspect", "--n", "2", "--seed", "3"]])
def test_curation_main_matches_jax(argv, tmp_path, capsys):
    """main's non-CLIP subcommands on two copies of one tree: the same
    output (the root's path aside) and the same trees after, byte for byte
    (the inspect grid included)."""
    src = make_tree(str(tmp_path / "src"), () if argv[0] == "inspect" else HOLES)
    outs = {}
    for name, mod in (("port", cur), ("jax", jcur)):
        root = str(tmp_path / name)
        shutil.copytree(src, root)
        extra = ["--out", str(tmp_path / "grids" / f"{name}.jpg")] if argv[0] == "inspect" \
            else []
        capsys.readouterr()
        mod.main([argv[0], root, *argv[1:], *extra])
        outs[name] = capsys.readouterr().out.replace(str(tmp_path / name), "ROOT").replace(
            str(tmp_path / "grids" / f"{name}.jpg"), "GRID")
    assert outs["port"] == outs["jax"]
    assert same_trees(str(tmp_path / "port"), str(tmp_path / "jax"))
    if argv[0] == "inspect":
        assert filecmp.cmp(str(tmp_path / "grids" / "port.jpg"),
                           str(tmp_path / "grids" / "jax.jpg"), shallow=False)
    if argv[0] == "missing":
        assert cur.find_missing_artifacts(src) == jcur.find_missing_artifacts(src)
        assert len(cur.find_missing_artifacts(src)) == 2


def test_curation_compare_matches_jax(tmp_path, capsys):
    """``compare`` of two safetensors files: the same report."""
    pytest.importorskip("safetensors")  # the JAX package's reader
    a, b = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    save_file({"p.w": torch.ones(2, 2), "p.b": torch.zeros(3), "q": torch.ones(1)}, a)
    save_file({"p.w": torch.ones(2, 2) * 2, "p.b": torch.zeros(3), "r": torch.ones(1)}, b)
    for argv in ([], ["--atol", "2"]):
        cur.main(["compare", a, b, *argv])
        got = capsys.readouterr().out
        jcur.main(["compare", a, b, *argv])
        assert got == capsys.readouterr().out


# ------------------------------------------------------------ hub rows
def _png(arr) -> bytes:
    import io

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def test_example_from_row_bit_equal():
    """Bytes, {"bytes": ...}, PIL images and arrays, with and without
    input_ids: both packages decode the same arrays."""
    g = np.random.default_rng(12)
    imgs = [g.integers(0, 255, (16, 12, 3), dtype=np.uint8) for _ in hub.SCHEMA_FIELDS]
    forms = [_png, lambda a: {"bytes": _png(a)}, Image.fromarray, lambda a: a]
    row = {f: forms[i % 4](im) for i, (f, im) in enumerate(zip(hub.SCHEMA_FIELDS, imgs))}
    for r in (row, dict(row, input_ids=list(range(77)))):
        got, want = hub.example_from_row(r), jhub.example_from_row(r)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(hub.example_from_row(row)["original"], imgs[0])


def test_hub_dataset_round_trip(tmp_path):
    """dataset_from_examples -> save_dataset -> load_hub_dataset on a local
    directory: the fixed 4-row test split and the train rows come back
    equal to what went in, and to what the JAX package's loader reads from
    the same directory."""
    pytest.importorskip("datasets")
    g = np.random.default_rng(13)
    examples = [{**{f: g.integers(0, 255, (8, 8, 3), dtype=np.uint8) for f in hub.SCHEMA_FIELDS},
                 "input_ids": g.integers(0, 49408, 77).astype(np.int32)} for _ in range(6)]
    ds = hub.dataset_from_examples(examples, cache_dir=str(tmp_path / "cache"))
    hub.save_dataset(ds, str(tmp_path / "ds"))
    train, test = hub.load_hub_dataset(str(tmp_path / "ds"))
    jtrain, jtest = jhub.load_hub_dataset(str(tmp_path / "ds"))
    assert len(test) == 4 and len(train) == len(jtrain) == 2
    back = test + [train.example(i) for i in range(len(train))]
    jback = jtest + [jtrain.example(i) for i in range(len(jtrain))]
    for got, want, ref in zip(back, jback, examples):
        for k in ref:
            assert np.array_equal(got[k], ref[k]) and np.array_equal(got[k], want[k]), k

"""The port's CLIP vision tower, CLIP preprocessing, dual-tower loader and
prompt miner against the JAX package, on the CPU in fp32.

The same weights go to both packages (a JAX init carried across by
``from_jax_params``, or one seeded CLIPModel safetensors file read by each
package's loader); the towers are TINY, the tokenizer the port's
character-level one, so no vocabulary file is needed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.core import pretrained as jpretrained
from edgestyle_tpu.data import prompts as jprompts
from edgestyle_tpu.models import clip_text as jclip_text
from edgestyle_tpu.models import clip_vision as jclip_vision
from edgestyle_tpu_torch.apps import tryon
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.porting import from_jax_params
from edgestyle_tpu_torch.core.pretrained import load_clip_model_params
from edgestyle_tpu_torch.core.safetensors import save_file
from edgestyle_tpu_torch.data import prompts
from edgestyle_tpu_torch.data.tokenizer import make_byte_tokenizer
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig
from edgestyle_tpu_torch.models.clip_vision import (
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    clip_preprocess,
)
from tests import golden_mirror as gm
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# the tower of tests/test_clip_vision_prompts.py (28 px: 4 patches)
TINY_VISION_28 = dict(hidden_size=64, num_layers=3, num_heads=4, patch_size=14, image_size=28,
                      intermediate_size=128, projection_dim=16)
# the miner's TINY towers: vision at CLIP's 224 px (257 tokens), text over
# the byte tokenizer's vocabulary at 77 tokens, both projecting to 16
TOK = make_byte_tokenizer()
TINY_VISION = dict(TINY_VISION_28, image_size=224)
TINY_TEXT = dict(vocab_size=len(TOK.encoder), hidden_size=32, num_layers=2, num_heads=4,
                 max_positions=77, intermediate_size=64, projection_dim=16)
TOL = 1e-4
BUILD_MINER = prompts.build_prompt_miner  # before any test patches it


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def max_err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


@pytest.fixture(scope="module")
def tower28():
    """TINY_VISION_28's JAX module, its params and the port's copy."""
    jcfg = jclip_vision.CLIPVisionConfig(**TINY_VISION_28)
    jmod = jclip_vision.CLIPVisionModelWithProjection(jcfg)
    jp = jax.jit(jmod.init)(jax.random.key(0), jnp.zeros((1, 28, 28, 3)))["params"]
    jp = jax.tree.map(np.asarray, jp)
    return jmod, jp, from_jax_params(jp, device="cpu")


@torch.no_grad()
def test_vision_tower_matches_jax(tower28):
    """last_hidden_state, pooled_output and image_embeds within 1e-4."""
    jmod, jp, tp = tower28
    x = np.random.default_rng(1).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = jax.jit(jmod.apply)({"params": jp}, jnp.asarray(x))
    got = CLIPVisionModelWithProjection(CLIPVisionConfig(**TINY_VISION_28))(tp, nchw(x))
    for k in ("last_hidden_state", "pooled_output", "image_embeds"):
        assert got[k].shape == want[k].shape, k
        assert max_err(got[k], want[k]) < TOL, k


def test_clip_preprocess_matches_jax_resize():
    """jax.image.resize's antialiased Keys cubic (a = -0.5) 512 -> 224 and
    CLIP's normalisation, within 1e-5. The port evaluates JAX's fp32 weight
    formula with numpy; XLA's compiled weights differ from it by 4e-7 at
    512 px (by 1e-5 at 300 px)."""
    x = np.random.default_rng(2).random((2, 512, 512, 3), dtype=np.float32)
    want = np.asarray(jclip_vision.clip_preprocess(jnp.asarray(x)))
    got = clip_preprocess(nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert max_err(got, want) < 1e-5


def clip_model_file(path) -> str:
    """A seeded dual-tower CLIPModel file of TINY_TEXT and TINY_VISION in
    HF's openai key layout (chip_smoke.py's manifest, logit_scale and the
    position_ids buffers included)."""
    from chip_smoke import clip_model_manifest

    t, v = TINY_TEXT, TINY_VISION
    manifest = clip_model_manifest(
        text=dict(layers=t["num_layers"], width=t["hidden_size"], positions=t["max_positions"],
                  vocab=t["vocab_size"], mlp=t["intermediate_size"]),
        vision=dict(layers=v["num_layers"], width=v["hidden_size"], mlp=v["intermediate_size"]),
        projection=t["projection_dim"])
    sd = {k: torch.from_numpy(w) for k, w in gm.synth_state_dict(
        {k: list(s) for k, s in manifest.items() if not k.endswith("position_ids")},
        seed=7).items()}
    sd["text_model.embeddings.position_ids"] = torch.arange(t["max_positions"])[None]
    sd["vision_model.embeddings.position_ids"] = torch.arange(257)[None]
    out = str(path / "model.safetensors")
    save_file(sd, out)
    return out


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """One file, read by both packages' loaders: (path, JAX trees, port trees)."""
    pytest.importorskip("safetensors")  # the JAX package's reader
    path = clip_model_file(tmp_path_factory.mktemp("clip"))
    jp = jpretrained.load_clip_model_params(path, TINY_TEXT["num_layers"],
                                            TINY_VISION["num_layers"])
    tp = load_clip_model_params(path, TINY_TEXT["num_layers"], TINY_VISION["num_layers"],
                                device="cpu")
    return path, jax.tree.map(np.asarray, jp), tp


def test_load_clip_model_params_matches_jax(clip_pair):
    """Both towers, leaf by leaf: the port's tree equals the JAX loader's
    carried across (logit_scale and position_ids dropped in both)."""
    _, jp, tp = clip_pair
    for tower in ("text", "vision"):
        want, got = flatten(from_jax_params(jp[tower], device="cpu")), flatten(tp[tower])
        assert got.keys() == want.keys(), tower
        for k, v in want.items():
            assert got[k].dtype == torch.float32 and torch.equal(got[k], v), (tower, k)
    assert {k[0] for k in flatten(tp["text"])} == {"text_model", "text_projection"}
    assert {k[0] for k in flatten(tp["vision"])} == {"vision_model", "visual_projection"}


def jax_encoders(jp):
    jt = jclip_text.CLIPTextModelWithProjection(jclip_text.CLIPTextConfig(**TINY_TEXT))
    jv = jclip_vision.CLIPVisionModelWithProjection(jclip_vision.CLIPVisionConfig(**TINY_VISION))
    text = jax.jit(lambda ids: jt.apply({"params": jp["text"]}, ids)["text_embeds"])
    image = jax.jit(lambda px: jv.apply({"params": jp["vision"]}, px)["image_embeds"])
    return text, image


def tiny_miner(tokenizer_dir, clip_model_dir, **kw):
    """build_prompt_miner on the TINY towers (it builds ViT-L/14 by default)."""
    return BUILD_MINER(tokenizer_dir, clip_model_dir, text_cfg=CLIPTextConfig(**TINY_TEXT),
                       vision_cfg=CLIPVisionConfig(**TINY_VISION), **kw)


@torch.no_grad()
def test_prompt_miner_matches_jax(clip_pair, tmp_path):
    """build_prompt_miner from the files (the full colour and garment banks
    through the byte tokenizer) against JAX's BestEmbeddings on its own
    loader's towers: the banks and every softmax score within 1e-5, and the
    same prompt strings, on two photos."""
    path, jp, _ = clip_pair
    TOK.save_pretrained(str(tmp_path))
    miner = tiny_miner(str(tmp_path), path, device="cpu")
    enc_text, enc_image = jax_encoders(jp)
    jbest = jprompts.BestEmbeddings(TOK, enc_image, enc_text)
    for bank in ("color_bank", "item_bank"):
        assert max_err(getattr(miner.best, bank), getattr(jbest, bank)) < 1e-5, bank

    photos = np.random.default_rng(3).random((2, 96, 96, 3), dtype=np.float32)
    jpx = jclip_vision.clip_preprocess(jnp.asarray(photos))
    img = enc_image(jpx)
    img = img / jnp.linalg.norm(img, axis=-1, keepdims=True)
    pc, pi = miner.best.probs(miner.pixel_values(photos))
    assert max_err(pc, jax.nn.softmax(100.0 * img @ jbest.color_bank.T, axis=-1)) < 1e-5
    assert max_err(pi, jax.nn.softmax(100.0 * img @ jbest.item_bank.T, axis=-1)) < 1e-5
    assert miner(photos) == jbest.find_best(jpx)


def test_best_embeddings_planted_case_matches_jax():
    """tests/test_clip_vision_prompts.py's planted case in both packages:
    pseudo-random unit text vectors over the full banks, an image embedded at
    one colour plus one item; both name the same four terms, the planted
    ones first."""
    d = 64
    table = {}
    for p in prompts.COLORS + prompts.CLOTHING_ITEMS:
        v = np.random.default_rng(sum(map(ord, p)) * 7919 + len(p)).standard_normal(d)
        table[p] = v / np.linalg.norm(v)
    img_vec = table["burgundy"] + table["trench coat"]

    def stub_text(banks, as_array):
        order = iter(banks)
        return lambda ids: as_array(np.stack([table[p] for p in next(order)]).astype(np.float32))

    tok = lambda texts: np.zeros((len(texts), 4), np.int32)  # noqa: E731
    banks = (prompts.COLORS, prompts.CLOTHING_ITEMS)
    img = np.repeat(img_vec[None], 1, 0).astype(np.float32)
    ours = prompts.BestEmbeddings(tok, lambda px: torch.from_numpy(img),
                                  stub_text(banks, torch.from_numpy)).find_best(
        torch.zeros(1, 3, 4, 4))
    ref = jprompts.BestEmbeddings(tok, lambda px: jnp.asarray(img),
                                  stub_text(banks, jnp.asarray)).find_best(jnp.zeros((1, 4, 4, 3)))
    assert ours == ref
    terms = ours[0][len(prompts.TRIGGER_WORD) + 2:].split(", ")
    assert terms[0] == "burgundy" and terms[2] == "trench coat"


def test_top2_takes_the_lower_index_on_ties():
    """jax.lax.top_k's order on ties, which torch.topk does not promise."""
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.5, 0.2, 0.5, 0.0]])
    assert prompts.top2(p).tolist() == [[1, 2], [0, 2]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(p.numpy()), 2)[1]).tolist() == [[1, 2], [0, 2]]


@torch.no_grad()
def test_clip_similarity_matches_jax(tower28):
    """The dataset's pair filter score on the TINY tower, within 1e-5."""
    jmod, jp, tp = tower28
    g = np.random.default_rng(4)
    a, b = (g.standard_normal((3, 28, 28, 3)).astype(np.float32) for _ in range(2))
    b[0] = a[0]
    port = CLIPVisionModelWithProjection(CLIPVisionConfig(**TINY_VISION_28))
    got = prompts.clip_similarity(lambda x: port(tp, x)["image_embeds"], nchw(a), nchw(b))
    want = jprompts.clip_similarity(
        lambda x: jmod.apply({"params": jp}, x)["image_embeds"], jnp.asarray(a), jnp.asarray(b))
    assert max_err(got, want) < 1e-5
    assert abs(float(got[0]) - 1.0) < 1e-5


class _System:
    """TryOnSystem's surface that main() calls: records the prompt ids."""

    def __init__(self, random_init, args, device):
        self.device = torch.device(device)
        self.calls = []
        _System.last = self

    def __call__(self, subject, c1, c2, ids, neg, steps, guidance, seed):
        self.calls.append((np.asarray(ids), np.asarray(neg)))
        return np.zeros((512, 512, 3), np.float32)


@pytest.mark.parametrize("prompt", [None, "a given prompt"])
def test_tryon_mines_the_prompt_unless_given(clip_pair, tmp_path, monkeypatch, capsys, prompt):
    """apps/tryon.py with --tokenizer_dir and --clip_model: without
    --prompt the miner's prompt for the first garment photo, joined to
    --prompt_text_to_add by a space, is what the generation's ids encode (and
    is printed); with --prompt the miner is never built."""
    from PIL import Image

    path, _, _ = clip_pair
    tok_dir = tmp_path / "tok"
    TOK.save_pretrained(str(tok_dir))
    g = np.random.default_rng(5)
    photos = []
    for name in ("s", "a", "b"):
        photos.append(str(tmp_path / f"{name}.png"))
        Image.fromarray(g.integers(0, 255, (80, 64, 3), dtype=np.uint8)).save(photos[-1])
    built = []

    def build(*a, **kw):
        built.append(a)
        return tiny_miner(*a, **kw)

    monkeypatch.setattr(tryon, "TryOnSystem", _System)
    monkeypatch.setattr(prompts, "build_prompt_miner", build)
    argv = ["--subject", photos[0], "--clothes1", photos[1], "--clothes2", photos[2],
            "--random_init", "--tokenizer_dir", str(tok_dir), "--clip_model", path,
            "--prompt_text_to_add", "studio photo", "--out", str(tmp_path / "r.png")]
    if prompt:
        argv += ["--prompt", prompt]
    tryon.main(argv, device="cpu")
    if prompt:
        assert not built
        text = prompt
    else:
        assert built == [(str(tok_dir), path)]
        c1 = tryon.load_image_512(photos[1]).astype(np.float32)[None] / 255.0
        (text,) = tiny_miner(str(tok_dir), path, device="cpu")(c1)
        assert text.startswith("edgestyle, ")
        assert f"mined prompt: {text}" in capsys.readouterr().out
    ids, neg = _System.last.calls[0]
    np.testing.assert_array_equal(ids, TOK([f"{text} studio photo"]))
    np.testing.assert_array_equal(neg, TOK([tryon.parse_args(argv).negative_prompt]))

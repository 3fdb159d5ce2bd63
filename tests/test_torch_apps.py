"""The port's ``infer``, ``distill`` and ``convert_checkpoint`` entry points
against the JAX package's (apps/infer.py, apps/distill.py,
apps/convert_checkpoint.py), on the CPU with no JAX program compiled:
the flag sets (aliases included), the artifact-dir addressing, the image
loader, the converter's files, and infer's image against the port's own
``EdgeStylePipeline.__call__`` on the same inputs, bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from edgestyle_tpu.apps import convert_checkpoint as jconvert
from edgestyle_tpu.apps import distill as jdistill
from edgestyle_tpu.apps import infer as jinfer
from edgestyle_tpu_torch.apps import convert_checkpoint, distill, infer
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.data import prompts
from edgestyle_tpu_torch.data.tokenizer import CLIPTokenizer, empty_prompt_ids, make_byte_tokenizer
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests.test_torch_data import DATA_CFG
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

ALIASES = ["--pretrained_model_name_or_path", "sd", "--pretrained_vae_name_or_path", "vae",
           "--pretrained_openpose_name_or_path", "op", "--controlnet_model_name_or_path", "cn"]
INFER_ARGVS = {
    "defaults": [],
    "aliases": ALIASES + ["--no-use_agnostic_images", "--guidance_sweep", "--scheduler", "dpm++"],
    "artifact_dirs": ["--source_path", "s", "--source_image_name", "0.jpg", "--target_path", "t",
                      "--target_image_name", "1.jpg", "--target_path2", "u",
                      "--target_image_name2", "2.jpg", "--use_agnostic_images",
                      "--result_path", "r", "--image_result_name", "g.png"],
    "slots_and_prompt": ["--agnostic", "a.png", "--original_openpose", "b.png", "--clothes2",
                         "c.png", "--prompt", "p", "--negative_prompt", "n", "--steps", "4",
                         "--guidance", "5", "--seed", "3", "--guess_mode",
                         "--control_guidance_start", "0.1", "--control_guidance_end", "0.9",
                         "--tokenizer_dir", "tok", "--clip_model", "clip",
                         "--prompt_text_to_add", "x", "--random_init", "--out", "o.png"],
}
DISTILL_ARGVS = {
    "defaults": [],
    "aliases": ALIASES + ["--random_init", "--use_agnostic_images"],
    "knobs": ["--distill_mode", "guidance", "--w_min", "4", "--lora_rank", "8",
              "--num_ddim_timesteps", "25", "--loss_type", "l2", "--huber_c", "0.01",
              "--ema_decay", "0.95", "--learning_rate", "2e-4", "--adam_beta1", "0.8",
              "--adam_beta2", "0.99", "--adam_epsilon", "1e-6", "--adam_weight_decay", "0.1",
              "--max_grad_norm", "0.5", "--max_train_steps", "7", "--max_train_samples", "9",
              "--mixed_precision", "fp16", "--seed", "2", "--output_dir", "o",
              "--logging_dir", "l", "--checkpointing_steps", "3",
              "--checkpoints_total_limit", "2", "--resume_from_checkpoint", "latest",
              "--logging_steps", "1", "--dataloader_num_workers", "2", "--dataset_dir", "d",
              "--resolution", "256", "--train_batch_size", "1",
              "--gradient_accumulation_steps", "3", "--w_max", "4"],
}


# ------------------------------------------------------------------ flags
@pytest.mark.parametrize("app,jax_app,argv", [
    *[(infer, jinfer, a) for a in INFER_ARGVS.values()],
    *[(distill, jdistill, a) for a in DISTILL_ARGVS.values()],
], ids=[f"infer-{k}" for k in INFER_ARGVS] + [f"distill-{k}" for k in DISTILL_ARGVS])
def test_parse_args_matches_jax(app, jax_app, argv):
    assert vars(app.parse_args(argv)) == vars(jax_app.parse_args(argv))


@pytest.mark.parametrize("app,argv", [(infer, ["--scheduler", "lcm"]),
                                      (infer, ["--mode", "lcm"]),
                                      (infer, ["--lcm_lora", "f.safetensors"]),
                                      (distill, ["--distill_mode", "progressive"]),
                                      (distill, ["--loss_type", "l1"])])
def test_parse_args_refuses_what_jax_refuses(app, argv, capsys):
    """Choices outside JAX's, and flags JAX's infer lacks (no --mode, no
    --lcm_lora), are errors in both."""
    jax_app = jinfer if app is infer else jdistill
    for parse in (app.parse_args, jax_app.parse_args):
        with pytest.raises(SystemExit):
            parse(argv)


@pytest.mark.parametrize("agnostic", [False, True])
def test_resolve_artifact_paths_matches_jax(agnostic):
    argv = INFER_ARGVS["artifact_dirs"][:-5] + (["--use_agnostic_images"] if agnostic else [])
    ours = infer.resolve_artifact_paths(infer.parse_args(argv))
    assert ours == jinfer.resolve_artifact_paths(jinfer.parse_args(argv))
    assert ours[0][0] == os.path.join("s", "agnostic" if agnostic else "head", "0.jpg")


@pytest.mark.parametrize("norm", [True, False])
def test_load_matches_jax(tmp_path, norm):
    """A non-square RGBA PNG: RGB, shorter side to 512, centre crop, then
    [-1, 1] or [0, 1], equal to JAX's _load bit for bit."""
    from PIL import Image

    path = str(tmp_path / "x.png")
    g = np.random.default_rng(1)
    Image.fromarray(g.integers(0, 255, (300, 420, 4), dtype=np.uint8)).save(path)
    ours = infer._load(path, norm)
    assert ours.shape == (1, 512, 512, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jinfer._load(path, norm))


# ------------------------------------------------------------------ infer
def _pipe_and_params():
    """infer.main's pipeline and weights at DATA_CFG (512 px conditioning
    needs its five-level VAE): bf16, the seed-0 init, every fp32 leaf cast
    to bf16."""
    pipe = EdgeStylePipeline(dataclasses.replace(DATA_CFG, dtype="bfloat16"), device="cpu")
    params = pipe.init_params(make_generator(0, "cpu"))
    return pipe, unflatten({k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                            for k, v in flatten(params).items()})


def _expected(pipe, params, imgs, ids, neg, steps, guidance, seed=0):
    cond = [torch.from_numpy(np.ascontiguousarray(im.transpose(0, 3, 1, 2))) for im in imgs]
    out = pipe(params, ids, neg, cond, generator=make_generator(seed, "cpu"),
               num_inference_steps=steps, guidance_scale=guidance)
    return out[0].float().permute(1, 2, 0).numpy()


def _png(path, seed, hw=(300, 260)):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    g = np.random.default_rng(seed)
    Image.fromarray(g.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(path)


def test_infer_main_single_image_with_a_mined_prompt(tmp_path, monkeypatch, capsys):
    """Per-slot paths with two slots missing (zeros), the prompt mined from
    the clothes slot by a stub miner and joined to --prompt_text_to_add:
    the written PNG is the pipeline's image on the same inputs, bit for
    bit."""
    from PIL import Image

    tok_dir = str(tmp_path / "tok")
    make_byte_tokenizer().save_pretrained(tok_dir)
    seen = []

    def build(tokenizer_dir, clip_model, device):
        assert (tokenizer_dir, clip_model, str(device)) == (tok_dir, "clip", "cpu")
        return lambda imgs01: seen.append(imgs01) or ["edgestyle, red, shirt"]

    monkeypatch.setattr(prompts, "build_prompt_miner", build)
    slots = {"agnostic": 1, "original_openpose": 2, "clothes": 3, "clothes_openpose": 4}
    argv = ["--random_init", "--steps", "2", "--guidance", "5", "--seed", "3",
            "--tokenizer_dir", tok_dir, "--clip_model", "clip", "--prompt_text_to_add",
            "studio photo", "--out", str(tmp_path / "o.png")]
    for slot, seed in slots.items():
        _png(str(tmp_path / f"{slot}.png"), seed)
        argv += [f"--{slot}", str(tmp_path / f"{slot}.png")]
    arr = infer.main(argv, device="cpu", base_cfg=DATA_CFG)
    assert "mined prompt: edgestyle, red, shirt" in capsys.readouterr().out
    imgs = [infer._load(str(tmp_path / f"{s}.png"), n) if s in slots
            else np.zeros((1, 512, 512, 3), np.float32)
            for s, n in zip(infer.SLOTS, infer.SLOT_NORM)]
    np.testing.assert_array_equal(seen[0], imgs[2] / 2.0 + 0.5)
    tok = CLIPTokenizer.from_pretrained_dir(tok_dir)
    pipe, params = _pipe_and_params()
    want = _expected(pipe, params, imgs, tok(["edgestyle, red, shirt studio photo"]),
                     tok([infer.parse_args([]).negative_prompt]), 2, 5.0, seed=3)
    want = (want * 255).astype(np.uint8)
    np.testing.assert_array_equal(arr, want)
    np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "o.png"))), want)


def test_infer_main_guidance_sweep_grid(tmp_path):
    """The artifact directories and --guidance_sweep: a (1536, 1536, 3) grid
    at --result_path/--image_result_name, its first row the three source
    photos, then six generations over linspace(1, 7, 6), each the
    pipeline's image at that guidance, bit for bit."""
    from PIL import Image

    for i, base in enumerate(("s", "c1", "c2")):
        for sub in ("head", "openpose", "clothes", "subject"):
            _png(str(tmp_path / base / sub / "0.png"), 10 * i + len(sub))
    argv = ["--random_init", "--steps", "1", "--guidance_sweep", "--source_path",
            str(tmp_path / "s"), "--source_image_name", "0.png", "--target_path",
            str(tmp_path / "c1"), "--target_image_name", "0.png", "--target_path2",
            str(tmp_path / "c2"), "--target_image_name2", "0.png", "--result_path",
            str(tmp_path / "res"), "--image_result_name", "grid.png"]
    arr = infer.main(argv, device="cpu", base_cfg=DATA_CFG)
    assert arr.shape == (1536, 1536, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "res" / "grid.png"))), arr)
    slot_paths, source_paths = infer.resolve_artifact_paths(infer.parse_args(argv))
    imgs = [infer._load(p, n) for p, n in zip(slot_paths, infer.SLOT_NORM)]
    pipe, params = _pipe_and_params()
    ids = empty_prompt_ids()
    tiles = [infer._load(p, False)[0] for p in source_paths]
    tiles += [_expected(pipe, params, imgs, ids, ids, 1, float(g))
              for g in np.linspace(1.0, 7.0, 6)]
    want = (np.concatenate([np.concatenate(tiles[i * 3:(i + 1) * 3], axis=1)
                            for i in range(3)], axis=0) * 255).astype(np.uint8)
    np.testing.assert_array_equal(arr, want)


# ------------------------------------------------ infer.main against JAX's
def _tile(guidance):
    """The stub pipelines' image at ``guidance``, (512, 512, 3) in [0, 1]: a
    different one at each scale, so the grid's tile order shows."""
    g = np.random.default_rng(int(round(guidance * 1000)))
    return g.random((512, 512, 3), dtype=np.float32)


@pytest.fixture
def stub_pipelines(monkeypatch):
    """Both packages' EdgeStylePipeline with a one-leaf fp32 init and a
    ``__call__`` that records what the app hands it (the conditioning moved
    to NHWC, the seed, the pipeline's dtype and sampler, the weights' dtype)
    and returns :func:`_tile` of the guidance; both prompt miners stubbed to
    record their input. Returns {"jax": [...], "port": [...]} of those
    records, one per call, the miners' under "mined"."""
    import jax
    import jax.numpy as jnp

    from edgestyle_tpu.core import cache as jcache
    from edgestyle_tpu.data import prompts as jprompts
    from edgestyle_tpu.pipelines import tryon as jtryon
    from edgestyle_tpu_torch.pipelines import tryon

    calls = {"jax": [], "port": []}

    def record(side, pipe, params, ids, neg, cond, seed, kw):
        calls[side].append({
            "cond": cond, "ids": np.asarray(ids), "neg": np.asarray(neg), "seed": seed,
            "weights": str(params["w"].dtype).replace("torch.", ""),
            "pipe": (str(pipe.cfg.dtype), pipe.cfg.scheduler), **kw})

    def jax_call(self, params, ids, neg, imgs, rng=None, **kw):
        record("jax", self, params, ids, neg, [np.asarray(i) for i in imgs],
               int(jax.random.key_data(rng)[-1]), kw)
        return jnp.asarray(_tile(kw["guidance_scale"]))[None]

    def port_call(self, params, ids, neg, cond, generator=None, **kw):
        record("port", self, params, ids, neg, [c.numpy().transpose(0, 2, 3, 1) for c in cond],
               generator.initial_seed(), kw)
        return torch.from_numpy(_tile(kw["guidance_scale"]).transpose(2, 0, 1).copy())[None]

    def miner(side):
        def build(tokenizer_dir, clip_model, **kw):
            def mine(imgs01):
                calls.setdefault("mined", {})[side] = (tokenizer_dir, clip_model,
                                                       np.asarray(imgs01))
                return ["edgestyle, red, shirt"]
            return mine
        return build

    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr(jtryon.EdgeStylePipeline, "init_params",
                        lambda self, rng: {"w": jnp.ones((1,), jnp.float32)})
    monkeypatch.setattr(jtryon.EdgeStylePipeline, "__call__", jax_call)
    monkeypatch.setattr(tryon.EdgeStylePipeline, "init_params",
                        lambda self, gen: {"w": torch.ones((1,))})
    monkeypatch.setattr(tryon.EdgeStylePipeline, "__call__", port_call)
    monkeypatch.setattr(jprompts, "build_prompt_miner", miner("jax"))
    monkeypatch.setattr(prompts, "build_prompt_miner", miner("port"))
    return calls


def _artifact_dirs(root):
    """Three artifact directories (subject, clothes 1 and 2), every view's
    PNG of a different seeded size."""
    flags = []
    for i, (flag, base) in enumerate((("source", "s"), ("target", "c1"), ("target2", "c2"))):
        for sub in ("head", "agnostic", "openpose", "clothes", "subject"):
            _png(os.path.join(root, base, sub, "0.png"), 10 * i + len(sub),
                 (300 + 7 * i + len(sub), 260 + 11 * i))
        suffix = "2" if flag == "target2" else ""
        flags += [f"--{flag.rstrip('2')}_path{suffix}", os.path.join(root, base),
                  f"--{flag.rstrip('2')}_image_name{suffix}", "0.png"]
    return flags


INFER_MAIN_CASES = {
    # per-slot paths, two slots missing (zeros), the prompt mined from the
    # clothes slot and joined to --prompt_text_to_add, every knob off its
    # default
    "slots_mined": lambda root, tok: [
        "--agnostic", f"{root}/in/agnostic.png", "--original_openpose", f"{root}/in/pose.png",
        "--clothes", f"{root}/in/clothes.png", "--clothes_openpose2", f"{root}/in/pose2.png",
        "--tokenizer_dir", tok, "--clip_model", "clip", "--prompt_text_to_add", "studio photo",
        "--negative_prompt", "blurry", "--steps", "3", "--guidance", "5", "--seed", "3",
        "--guess_mode", "--control_guidance_start", "0.1", "--control_guidance_end", "0.8",
        "--scheduler", "dpm++"],
    # the artifact directories: the three source photos and six scales
    "sweep_artifact_dirs": lambda root, tok: _artifact_dirs(root) + [
        "--use_agnostic_images", "--guidance_sweep", "--steps", "2"],
    # per-slot paths: nine scales; the tokenizer without a miner
    "sweep_slots": lambda root, tok: [
        "--clothes", f"{root}/in/clothes.png", "--clothes2", f"{root}/in/pose2.png",
        "--tokenizer_dir", tok, "--prompt", "a coat", "--guidance_sweep", "--seed", "7"],
}


@pytest.mark.parametrize("case", list(INFER_MAIN_CASES))
def test_infer_main_matches_jax(tmp_path, stub_pipelines, case):
    """JAX's infer.main and the port's on the same argv, both pipelines
    stubbed (no model runs): the same calls in the same order, each with
    the same conditioning (the port's NCHW moved to NHWC), prompt ids,
    negative ids, seed, steps, guidance, guess mode and control window, the
    pipeline's bf16 and sampler and the weights cast to bf16; the same
    miner input; and the same PNG, bit for bit (the grid's layout and tile
    order included)."""
    from PIL import Image

    root = str(tmp_path)
    for name, seed in (("agnostic", 1), ("pose", 2), ("clothes", 3), ("pose2", 4)):
        _png(f"{root}/in/{name}.png", seed)
    tok = f"{root}/tok"
    make_byte_tokenizer().save_pretrained(tok)
    argv = ["--random_init"] + INFER_MAIN_CASES[case](root, tok)
    outs = {}
    for side, main in (("jax", jinfer.main), ("port", lambda a: infer.main(a, device="cpu"))):
        if "--use_agnostic_images" in argv:
            out = ["--result_path", f"{root}/{side}", "--image_result_name", "grid.png"]
            outs[side] = f"{root}/{side}/grid.png"
        else:
            outs[side] = f"{root}/{side}.png"
            out = ["--out", outs[side]]
        main(argv + out)
    calls = stub_pipelines
    n = (9 if "--use_agnostic_images" not in argv else 6) if "--guidance_sweep" in argv else 1
    assert len(calls["jax"]) == len(calls["port"]) == n
    for j, p in zip(calls["jax"], calls["port"]):
        assert len(j["cond"]) == len(p["cond"]) == 6
        for a, b in zip(j["cond"], p["cond"]):
            np.testing.assert_array_equal(b, a)
        for k in ("ids", "neg"):
            np.testing.assert_array_equal(p[k], j[k])
        assert {k: v for k, v in p.items() if k not in ("cond", "ids", "neg")} == {
            k: v for k, v in j.items() if k not in ("cond", "ids", "neg")}
    assert calls["port"][0]["weights"] == "bfloat16" and calls["port"][0]["pipe"][0] == "bfloat16"
    if "--clip_model" in argv:
        (jt, jc, ji), (pt, pc, pi) = calls["mined"]["jax"], calls["mined"]["port"]
        assert (jt, jc) == (pt, pc) == (tok, "clip")
        np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(np.asarray(Image.open(outs["port"])),
                                  np.asarray(Image.open(outs["jax"])))


@pytest.mark.parametrize("app", [infer, distill])
def test_entry_points_refuse_the_cpu_unless_asked(app):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(["--random_init"])


# ------------------------------------------------------- convert_checkpoint
@pytest.mark.parametrize("wrapped", [False, True])
def test_convert_matches_jax(tmp_path, wrapped):
    """A raw and a {"state_dict"}-wrapped torch.save: the port's file and
    the JAX package's hold the same keys, dtypes and values (read back with
    numpy through the safetensors package)."""
    from safetensors.numpy import load_file

    g = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn((3, 5, 2, 2), generator=g).to(memory_format=torch.channels_last),
          "a.bias": torch.randn((3,), generator=g).half(),
          "b.num_batches_tracked": torch.tensor(7),
          "c.t": torch.randn((6, 4), generator=g).t()}
    src = str(tmp_path / "m.pt")
    torch.save({"state_dict": sd, "epoch": 3} if wrapped else sd, src)
    ours, ref = str(tmp_path / "ours.safetensors"), str(tmp_path / "ref.safetensors")
    assert convert_checkpoint.convert(src, ours) == jconvert.convert(src, ref) == 4
    a, b = load_file(ours), load_file(ref)
    assert a.keys() == b.keys() == sd.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])
    convert_checkpoint.main([src, ours])


def test_full_module_pickles_are_refused_by_both(tmp_path):
    src = str(tmp_path / "module.pt")
    torch.save(torch.nn.Linear(2, 2), src)
    for convert in (convert_checkpoint.convert, jconvert.convert):
        with pytest.raises(ValueError, match="not a weights-only torch checkpoint"):
            convert(src, str(tmp_path / "x.safetensors"))

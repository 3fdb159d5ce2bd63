"""Parity of the PyTorch port's ControlLoRA trainer (edgestyle_tpu_torch
training/ and apps/train.py) with the JAX package's, on the CPU in fp32 at
the TINY test configs: the noise schedule, Min-SNR, the LR schedules, the
optimizers, conv LoRA, the draws, checkpoints and the entry point. The long
whole-trainer parity tests (loss and gradients, train steps, remat) are in
``test_torch_training_parity.py``, so that a run giving each file one worker
runs the two side by side.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgestyle_tpu.apps import train as jtrain_app
from edgestyle_tpu.models.unet import init_lora_params as j_init_lora
from edgestyle_tpu.models.unet import merge_lora as j_merge_lora
from edgestyle_tpu.models.unet import split_trunk_params as j_split_trunk
from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu.schedulers import ddpm as jddpm
from edgestyle_tpu.training import minsnr as jminsnr
from edgestyle_tpu.training.prodigy import prodigy as j_prodigy
from edgestyle_tpu.training.schedules import NAMES as J_NAMES
from edgestyle_tpu.training.schedules import build_lr_schedule as j_build_lr_schedule
from edgestyle_tpu_torch.apps import train as train_app
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.porting import from_jax_params
from edgestyle_tpu_torch.models.unet import init_lora_params, is_lora_conv_path, merge_lora
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.schedulers import ddpm
from edgestyle_tpu_torch.training import checkpoint, minsnr, optim
from edgestyle_tpu_torch.training import train_step as tts
from edgestyle_tpu_torch.training.prodigy import Prodigy
from edgestyle_tpu_torch.training.schedules import NAMES, build_lr_schedule
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import perturb, port
from tests.test_torch_pipeline import TINY_PIPE
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

TIMESTEPS = np.array([0, 10, 250, 500, 999])


def close_tree(got, ref, rtol, what, atol=None):
    """Leaf by leaf: |got - ref| <= rtol * max|ref| + atol, where atol (per
    leaf, default 1e-7) may be a dict of the leaves' own limits."""
    got, ref = flatten(got), flatten(ref)
    assert got.keys() == ref.keys(), what
    for k, r in ref.items():
        a = got[k].detach().float()
        r = r.detach().float()
        assert a.shape == r.shape, (what, k)
        err = (a - r).abs().max().item()
        lim = rtol * r.abs().max().item() + (1e-7 if atol is None else atol[k])
        assert err <= lim, (what, k, err, r.abs().max().item())


# ------------------------------------------------------------ DDPM, Min-SNR
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddpm_training_functions_match_jax(rng, prediction_type):
    js = dataclasses.replace(jddpm.NoiseSchedule.sd15(), prediction_type=prediction_type)
    sched = dataclasses.replace(ddpm.NoiseSchedule.sd15(), prediction_type=prediction_type)
    ds = sched.to("cpu")
    x0 = rng.standard_normal((5, 3, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((5, 3, 4, 4)).astype(np.float32)
    t = torch.from_numpy(TIMESTEPS)
    jt = jnp.asarray(TIMESTEPS)
    pairs = [
        (ddpm.add_noise(ds, torch.from_numpy(x0), torch.from_numpy(noise), t),
         jddpm.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), jt)),
        (ddpm.get_velocity(ds, torch.from_numpy(x0), torch.from_numpy(noise), t),
         jddpm.get_velocity(js, jnp.asarray(x0), jnp.asarray(noise), jt)),
        (ddpm.training_target(ds, torch.from_numpy(x0), torch.from_numpy(noise), t),
         jddpm.training_target(js, jnp.asarray(x0), jnp.asarray(noise), jt)),
        (ddpm.compute_snr(ds, t), jddpm.compute_snr(js, jt)),
        (minsnr.min_snr_weights(ds, t, 5.0), jminsnr.min_snr_weights(js, jt, 5.0)),
    ]
    for got, ref in pairs:  # fp32 on both sides: a few ulps of sqrt and products
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    pred = rng.standard_normal((5, 3, 4, 4)).astype(np.float32)
    w = rng.random(5).astype(np.float32)
    np.testing.assert_allclose(
        minsnr.weighted_mse(torch.from_numpy(pred), torch.from_numpy(noise),
                            torch.from_numpy(w)).item(),
        float(jminsnr.weighted_mse(jnp.asarray(pred), jnp.asarray(noise), jnp.asarray(w))),
        rtol=1e-6)


def test_device_schedule_indexes_device_timesteps():
    ds = ddpm.NoiseSchedule.sd15().to("cpu")
    assert ds.alphas_cumprod.dtype == torch.float32 and ds.alphas_cumprod.shape == (1000,)
    assert ds.num_train_timesteps == 1000 and ds.prediction_type == "epsilon"


# ------------------------------------------------------------- LR schedules
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_jax(name, warmup):
    """Host floats against JAX's fp32 schedule: 1e-5 relative (fp32 cos and
    powers near the end of a decay)."""
    assert NAMES == J_NAMES
    kw = dict(warmup_steps=warmup, total_steps=10, num_cycles=2.0, power=2.0)
    ours = build_lr_schedule(name, 0.5, **kw)
    ref = j_build_lr_schedule(name, 0.5, **kw)
    for step in (0, 1, 2, 3, 4, 6, 9, 10, 11, 15):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"{name} step {step}")


def test_lr_schedule_rejects_bad_names():
    with pytest.raises(ValueError, match="unknown"):
        build_lr_schedule("exponential", 1.0)
    with pytest.raises(ValueError, match="total_steps"):
        build_lr_schedule("cosine", 1.0)


# ------------------------------------------------------------- optimizers
PRODIGY_CASES = {
    "recipe": dict(weight_decay=1e-4),
    "plain": dict(beta3=0.9, weight_decay=0.0, use_bias_correction=False,
                  safeguard_warmup=False),
    "coupled_wd_schedule": dict(weight_decay=1e-2, decouple=False, schedule=True),
}


@pytest.mark.parametrize("case", list(PRODIGY_CASES))
def test_prodigy_matches_jax(case):
    """25 steps of a quadratic, both sides given the same grads (2 x +
    c at JAX's params): d, d_max, d_numerator and the params against the JAX
    Prodigy, while d grows from d0 (fp32 on both sides; the scalars are fp32
    sums of products that nearly cancel, 1e-4)."""
    kw = dict(PRODIGY_CASES[case])
    if kw.pop("schedule", False):
        kw["learning_rate"] = build_lr_schedule("linear", 1.0, 1, 100)
        jkw = dict(kw, learning_rate=j_build_lr_schedule("linear", 1.0, 1, 100))
    else:
        jkw = kw
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    shift = {"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jopt, opt = j_prodigy(**jkw), Prodigy(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jopt.init(jp), opt.init(tp)
    ds = []
    for step in range(25):
        grads = jax.tree.map(lambda x, c: np.asarray(2 * x) + c, jp, shift)
        jg = jax.tree.map(jnp.asarray, grads)
        tg = jax.tree.map(torch.from_numpy, grads)
        ju, js = jopt.update(jg, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = opt.update(tg, ts, tp)
        tp = optim.apply_updates(tp, tu)
        assert ts["step"] == step + 1
        for key in ("d", "d_max", "d_numerator"):
            np.testing.assert_allclose(ts[key].item(), float(getattr(js, key)), rtol=1e-4,
                                       err_msg=f"{key} at step {step}")
        close_tree(tp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp), 1e-5,
                   f"params at step {step}")
        ds.append(ts["d"].item())
    assert all(b >= a for a, b in zip(ds, ds[1:])), ds
    assert ds[-1] > 1e-6, ds  # d grew from d0


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """optax's formula: g * max_norm / ||g|| once ||g|| >= max_norm, else g
    unchanged (no + 1e-6 as in clip_grad_norm_)."""
    rng = np.random.default_rng(1)
    grads = {"a": (rng.standard_normal((6, 2)) * scale).astype(np.float32),
             "b": {"c": (rng.standard_normal((3,)) * scale).astype(np.float32)}}
    ref, _ = optax.clip_by_global_norm(1.0).update(jax.tree.map(jnp.asarray, grads), None)
    got = optim.clip_by_global_norm(jax.tree.map(torch.from_numpy, grads), 1.0)
    close_tree(got, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref), 1e-6, "clip")
    if scale < 1:
        assert torch.equal(got["a"], torch.from_numpy(grads["a"]))


def test_adamw_matches_optax():
    """Three steps with a warmup schedule, weight decay on: optax.adamw."""
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32)}
    kw = dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=1e-2)
    jopt = optax.adamw(j_build_lr_schedule("linear", 1e-2, 1, 4), **kw)
    opt = optim.AdamW(build_lr_schedule("linear", 1e-2, 1, 4), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jopt.init(jp), opt.init(tp)
    for _ in range(3):
        g = {"a": rng.standard_normal((4, 3)).astype(np.float32)}
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = opt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        tp = optim.apply_updates(tp, tu)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-7)


def test_make_optimizer_chains_clipping():
    opt = tts.make_optimizer(tts.TrainConfig(max_grad_norm=0.5))
    assert isinstance(opt, optim.ClippedOptimizer) and isinstance(opt.inner, Prodigy)
    assert isinstance(tts.make_optimizer(tts.TrainConfig(optimizer="adamw")).inner, optim.AdamW)
    with pytest.raises(ValueError, match="optimizer"):
        tts.make_optimizer(tts.TrainConfig(optimizer="sgd"))


# -------------------------------------------------------------- conv LoRA
@pytest.fixture(scope="module")
def jax_unet_trunk():
    """The TINY pipeline's UNet params, perturbed, as the ControlNet trunk:
    init_params' own UNet init (its key and inputs) without the VAE, CLIP
    and ControlNet inits the adapter tests do not read."""
    jpipe = JPipeline(J_TINY_PIPE, attn_impl="xla")
    cfg = jpipe.cfg
    hw = cfg.vae.sample_size // jpipe.vae_downscale
    params = jax.jit(jpipe.unet.init)(
        jax.random.split(jax.random.key(0), 8)[2], jnp.zeros((1, hw, hw, cfg.unet.in_channels)),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.clip.max_positions, cfg.clip.hidden_size)))["params"]
    return j_split_trunk(perturb(params, np.random.default_rng(0)))


def test_conv_lora_init_matches_jax_layout(jax_unet_trunk):
    """Same adapter paths as JAX with and without conv adapters; shapes in
    the port's layout; conv adapters take the linear rank (the reference
    quirk); ups are zero."""
    trunk = port(jax_unet_trunk)
    gen = torch.Generator().manual_seed(0)
    for conv_rank in (0, 2):
        jl = flatten(from_jax_params(
            j_init_lora(jax.random.key(1), jax_unet_trunk, 4, conv_rank), "cpu"))
        tl = flatten(init_lora_params(gen, trunk, 4, conv_rank))
        assert tl.keys() == jl.keys()
        assert {k: tuple(v.shape) for k, v in tl.items()} == \
            {k: tuple(v.shape) for k, v in jl.items()}
        n_conv = sum(1 for k in tl if k[-1] == "down" and tl[k].ndim == 4)
        assert (n_conv > 0) == (conv_rank > 0)
        assert all(v.abs().max() == 0 for k, v in tl.items() if k[-1] == "up")
        if conv_rank:
            down = tl[("conv_in", "kernel", "down")]
            assert down.shape[0] == 4 and is_lora_conv_path(("conv_in", "kernel"))


def test_conv_lora_merge_matches_jax(jax_unet_trunk):
    """Linear and conv adapters from a JAX tree (re-laid out by
    from_jax_params), merged at scale 0.5 on both sides; the merged conv
    kernels stay channels_last for the fused conv kernel."""
    lora = j_init_lora(jax.random.key(2), jax_unet_trunk, 4, conv_rank=1)
    lora = perturb(lora, np.random.default_rng(3), 0.1)
    ref = flatten(port(j_merge_lora(jax_unet_trunk, lora, 0.5)))
    out = flatten(merge_lora(port(jax_unet_trunk), from_jax_params(lora, "cpu"), 0.5))
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(out[k].numpy(), v.numpy(), atol=1e-5, err_msg=str(k))
    conv = out[("down_blocks_0", "resnets_0", "conv1", "kernel")]
    assert conv.is_contiguous(memory_format=torch.channels_last)


def test_from_jax_params_relays_lora_adapters(jax_unet_trunk):
    """Linear down (in, r) -> (r, in), up (r, out) -> (out, r); conv down
    (kh, kw, in, r) -> (r, in, kh, kw); fp32 whatever the compute dtype."""
    lora = perturb(j_init_lora(jax.random.key(4), jax_unet_trunk, 3, conv_rank=1),
                   np.random.default_rng(5))
    got = from_jax_params(lora, "cpu", torch.bfloat16)
    q = lora["down_blocks_0"]["attentions_0"]["blocks_0"]["attn1"]["to_q"]["kernel"]
    tq = got["down_blocks_0"]["attentions_0"]["blocks_0"]["attn1"]["to_q"]["kernel"]
    assert tq["down"].dtype == torch.float32
    np.testing.assert_array_equal(tq["down"].numpy(), q["down"].T)
    np.testing.assert_array_equal(tq["up"].numpy(), q["up"].T)
    c = lora["conv_in"]["kernel"]
    tc = got["conv_in"]["kernel"]
    np.testing.assert_array_equal(tc["down"].numpy(), c["down"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tc["up"].numpy(), c["up"].T)


# -------------------------------------------------------------- the draws
H = 16  # latent size of the 32 px TINY pipeline (a 2-level VAE: 2x down)


def test_sample_draws_shapes():
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    batch = {"original": torch.zeros((3, 2, 3, 32, 32))}
    draws = tts.sample_draws(pipe, tts.TrainConfig(), batch, torch.Generator().manual_seed(0))
    assert len(draws) == 3
    d = draws[0]
    assert d["vae_eps"].shape == (2, 4, H, H) and d["cond_eps"].shape == (6, 4, H, H)
    assert d["noise"].shape == (2, 4, H, H) and d["flip"].dtype == torch.bool
    assert d["timesteps"].dtype == torch.long and 0 <= d["timesteps"].min()
    assert d["timesteps"].max() < 1000


def test_swap_clothes_swaps_flagged_samples():
    batch = {k: torch.full((2, 3, 1, 1), float(i)) for i, k in enumerate(
        ("clothes", "clothes2", "clothes_openpose", "clothes_openpose2"))}
    out = tts._swap_clothes(batch, torch.tensor([True, False]))
    assert out["clothes"][:, 0, 0, 0].tolist() == [1.0, 0.0]
    assert out["clothes2"][:, 0, 0, 0].tolist() == [0.0, 1.0]
    assert out["clothes_openpose"][:, 0, 0, 0].tolist() == [3.0, 2.0]


# -------------------------------------------------------------- checkpoint
def _state(step, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"trainable": {"lora_0": {"w": torch.randn((3, 2), generator=g)}},
            "opt_state": {"step": step, "d": torch.tensor(1e-6), "exp_avg": {"w": torch.zeros(2)}},
            "step": step}


def test_checkpoint_round_trip_and_rotation(tmp_path):
    root = str(tmp_path)
    for step in (1, 2, 3, 4):
        path = checkpoint.save_checkpoint(root, _state(step, step), total_limit=2)
        assert os.path.isfile(os.path.join(path, checkpoint.STATE_FILE))
    assert checkpoint.list_checkpoints(root) == [3, 4]
    back = checkpoint.load_checkpoint(root, device="cpu")
    assert checkpoint.states_equal(back, _state(4, 4))
    assert not checkpoint.states_equal(checkpoint.load_checkpoint(root, 3, "cpu"), _state(4, 4))
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none"), device="cpu")


# -------------------------------------------------------- the entry point
def test_parse_args_matches_jax():
    """The flag set and every default, and a few flags given."""
    assert vars(train_app.parse_args([])) == vars(jtrain_app.parse_args([]))
    argv = ["--resolution", "256", "--prodigy_decouple=False", "--use_agnostic_images",
            "--lr_scheduler", "linear", "--pretrained_model_name_or_path", "x",
            "--controllora_conv2d_rank", "4", "--gradient_checkpointing"]
    assert vars(train_app.parse_args(argv)) == vars(jtrain_app.parse_args(argv))
    with pytest.raises(SystemExit):
        train_app.parse_args(["--resolution", "100"])


def test_synthetic_loader_matches_jax():
    """The same numpy draws from --seed, images NHWC -> NCHW."""
    argv = ["--seed", "3", "--resolution", "16", "--train_batch_size", "2",
            "--gradient_accumulation_steps", "2"]
    ours = train_app.synthetic_loader(train_app.parse_args(argv))
    ref = jtrain_app._synthetic_loader(jtrain_app.parse_args(argv))
    for _ in range(2):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k, v in b.items():
            got = a[k] if k == "input_ids" else a[k].transpose(0, 1, 3, 4, 2)
            np.testing.assert_array_equal(got, v, err_msg=k)


TRAIN_CFG = dataclasses.replace(  # the synthetic loader's ids need CLIP's vocab and 77 tokens
    TINY_PIPE, clip=dataclasses.replace(TINY_PIPE.clip, vocab_size=49408, max_positions=77))


def test_train_main_runs_checkpoints_and_resumes(tmp_path, capsys):
    """The entry point at TINY width on the CPU: JSON log lines, a finite loss,
    a monotone d, the final checkpoint equal to the returned state, and a
    resume that continues from it."""
    argv = ["--random_init", "--resolution", "32", "--train_batch_size", "1",
            "--gradient_accumulation_steps", "2", "--max_train_steps", "2", "--logging_steps",
            "1", "--controllora_linear_rank", "4", "--mixed_precision", "no",
            "--output_dir", str(tmp_path)]
    out = train_app.main(argv, device="cpu", base_cfg=TRAIN_CFG)
    assert [r["step"] for r in out["log"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in out["log"])
    assert out["log"][1]["d"] >= out["log"][0]["d"]
    assert '"done": true' in capsys.readouterr().out
    assert checkpoint.list_checkpoints(str(tmp_path)) == [2]
    saved = checkpoint.load_checkpoint(str(tmp_path), device="cpu")
    assert checkpoint.states_equal(saved, out["state"])
    from edgestyle_tpu_torch.core.pretrained import load_edgestyle_pretrained_dir

    for exported in (load_edgestyle_pretrained_dir(str(tmp_path / "controlnet"), "cpu"),
                     checkpoint.import_safetensors(
                         str(tmp_path / "edgestyle_trainable.safetensors"), "cpu")):
        assert checkpoint.states_equal(exported, out["state"]["trainable"])
    out2 = train_app.main(argv[:-4] + ["--max_train_steps", "3", "--output_dir", str(tmp_path),
                                       "--resume_from_checkpoint", "latest"],
                          device="cpu", base_cfg=TRAIN_CFG)
    assert [r["step"] for r in out2["log"]] == [3]
    assert checkpoint.list_checkpoints(str(tmp_path)) == [2, 3]


def test_train_build_keeps_frozen_bf16_and_trainables_fp32():
    args = train_app.parse_args(["--random_init", "--resolution", "32",
                                 "--controllora_linear_rank", "4",
                                 "--controllora_conv2d_rank", "1"])
    pipe, frozen, tcfg, state, max_steps = train_app.build(args, "cpu", TRAIN_CFG)
    assert pipe.dtype == torch.bfloat16 and max_steps == 1000
    assert tcfg.grad_accum == 32 and tcfg.snr_gamma == 5.0 and tcfg.optimizer == "prodigy"
    assert all(v.dtype == torch.bfloat16 for v in flatten(frozen).values())
    assert all(v.dtype == torch.float32 for v in flatten(state["trainable"]).values())
    assert any(v.ndim == 4 for k, v in flatten(state["trainable"]["lora_0"]).items()
               if k[-1] == "down")


@pytest.mark.parametrize("flags", [["--dataset_dir", "d", "--random_init"],
                                   ["--random_init", "--validation_steps", "5"],
                                   ["--random_init", "--dataloader_num_workers", "2"]])
def test_train_main_refuses_unported_flags(flags, monkeypatch):
    """The dataset, validation and prefetch are ported (tests/test_torch_data.py);
    with them, ranks that cannot share the micro-batch (the default 2 over
    3) are refused before any group forms (data parallelism itself:
    tests/test_torch_multicard.py)."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match=r"must be divisible by the device count \(3\)"):
        train_app.main(flags, device="cpu", base_cfg=TRAIN_CFG)


@pytest.mark.parametrize("flags,missing", [
    ([], "--pretrained_model, --vae, --openpose_controlnet"),
    (["--pretrained_model", "sd", "--vae", "vae"], "missing --openpose_controlnet"),
])
def test_train_main_without_weights_names_the_directories(flags, missing):
    with pytest.raises(ValueError, match=missing):
        train_app.main(flags, device="cpu", base_cfg=TRAIN_CFG)

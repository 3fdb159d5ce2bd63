"""Parity of the PyTorch port's ControlLoRA trainer (edgestyle_tpu_torch
training/ and apps/train.py) with the JAX package's, on the CPU in fp32 at
the TINY test configs.

The same numpy inputs, weights and random draws go through both sides: the
JAX trainer draws its noise from ``jax.random`` keys inside the loss, so
these tests make the same draws from the same key splits and hand them to
the port's loss, which takes its draws as arguments.
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
from edgestyle_tpu.training import train_step as jts
from edgestyle_tpu.training.prodigy import prodigy as j_prodigy
from edgestyle_tpu.training.schedules import NAMES as J_NAMES
from edgestyle_tpu.training.schedules import build_lr_schedule as j_build_lr_schedule
from edgestyle_tpu_torch.apps import train as train_app
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.core.porting import from_jax_params, from_jax_train_state
from edgestyle_tpu_torch.models.unet import init_lora_params, is_lora_conv_path, merge_lora
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.schedulers import ddpm
from edgestyle_tpu_torch.training import checkpoint, minsnr, optim
from edgestyle_tpu_torch.training import train_step as tts
from edgestyle_tpu_torch.training.prodigy import Prodigy
from edgestyle_tpu_torch.training.schedules import NAMES, build_lr_schedule
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import perturb, port
from tests.test_torch_ops import nchw
from tests.test_torch_pipeline import TINY_PIPE

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
    jpipe = JPipeline(J_TINY_PIPE, attn_impl="xla")
    params = jpipe.init_params(jax.random.key(0))
    return j_split_trunk(perturb(params["unet"], np.random.default_rng(0)))


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


# -------------------------------------------------------- the train step
H = 16  # latent size of the 32 px TINY pipeline (a 2-level VAE: 2x down)


def jax_draws(r, b):
    """The draws JAX's controlnet_loss_fn makes from its key ``r``
    (train_step.py: split into vae, noise, t, swap, cond), for the port's
    loss: NCHW noise, int64 timesteps, bool flips."""
    r_vae, r_noise, r_t, r_swap, r_cond = jax.random.split(r, 5)
    flip = jax.random.bernoulli(r_swap, 0.5, (b, 1, 1, 1))
    return {
        "vae_eps": nchw(jax.random.normal(r_vae, (b, H, H, 4), jnp.float32)),
        "cond_eps": nchw(jax.random.normal(r_cond, (3 * b, H, H, 4), jnp.float32)),
        "noise": nchw(jax.random.normal(r_noise, (b, H, H, 4), jnp.float32)),
        "timesteps": torch.from_numpy(np.array(jax.random.randint(r_t, (b,), 0, 1000))).long(),
        "flip": torch.from_numpy(np.array(flip).reshape(b)),
    }


def jax_batch(seed, accum, mb):
    g = np.random.default_rng(seed)
    img = lambda: (g.standard_normal((accum, mb, 32, 32, 3)) * 0.2).astype(np.float32)  # noqa: E731
    batch = {k: img() for k in tts.BATCH_KEYS if k != "input_ids"}
    batch["input_ids"] = g.integers(1, 99, (accum, mb, 7)).astype(np.int32)
    return batch


def port_batch(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.long() if k == "input_ids" else t.permute(0, 1, 4, 2, 3).contiguous()
    return out


@pytest.fixture(scope="module")
def train_pair():
    """JAX and port trainers on the same perturbed weights: every frozen
    leaf and every trainable (heads and LoRA ups included) gets seeded
    noise, so every trainable gradient is live."""
    rng = np.random.default_rng(0)
    jpipe = JPipeline(J_TINY_PIPE, attn_impl="xla")
    params = perturb(jpipe.init_params(jax.random.key(0)), rng)
    frozen = {"vae": params["vae"], "clip": params["clip"], "unet": params["unet"],
              "static": params["controlnet"]["static"]}
    trainable = perturb(jts.init_trainable(jpipe, jax.random.key(1), params["unet"],
                                           lora_rank=4), rng)
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    return dict(jpipe=jpipe, pipe=pipe, jfrozen=frozen, jtrainable=trainable,
                frozen=port(frozen), trainable=from_jax_params(trainable, "cpu"))


def test_init_trainable_matches_jax_structure(train_pair):
    """The port's fresh trainables: the JAX tree's groups, paths and shapes
    (in the port's layout), fp32; heads zero, LoRA ups zero."""
    pipe = train_pair["pipe"]
    ours = tts.init_trainable(pipe, torch.Generator().manual_seed(0),
                              train_pair["frozen"]["unet"], lora_rank=4)
    assert tuple(ours) == tts.TRAINABLE_GROUPS
    ref = flatten(train_pair["trainable"])
    got = flatten(ours)
    assert got.keys() == ref.keys()
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.shape == ref[k].shape, k
        if k[0].startswith("heads") or k[-1] == "up":
            assert v.abs().max() == 0, k


@pytest.mark.heavy
def test_controlnet_loss_and_grads_match_jax(train_pair):
    """One micro-batch of 2 (so the swap flips per sample): the loss and the
    gradient of every trainable leaf against jax.value_and_grad, with JAX's
    own draws. fp32 on both sides: 1e-5 relative on the loss, 2e-3 of each
    leaf's largest gradient (convolutions and attention sum in another
    order, and the gradients are small differences of large terms)."""
    tp = train_pair
    jcfg = jts.TrainConfig()
    batch = jax_batch(0, 1, 2)
    mb = jax.tree.map(lambda a: jnp.asarray(a[0]), batch)
    r = jax.random.key(11)
    (jloss, _), jgrads = jax.value_and_grad(jts.controlnet_loss_fn, has_aux=True)(
        tp["jtrainable"], tp["jfrozen"], tp["jpipe"], jddpm.NoiseSchedule.sd15(), jcfg, mb, r)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten(tp["trainable"]).items()}
    loss = tts.controlnet_loss_fn(unflatten(leaves), tp["frozen"], tp["pipe"],
                                  ddpm.NoiseSchedule.sd15().to("cpu"), tts.TrainConfig(),
                                  {k: v[0] for k, v in port_batch(batch).items()},
                                  jax_draws(r, 2))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = flatten(from_jax_params(jax.tree.map(np.asarray, jgrads), "cpu"))
    got = unflatten(dict(zip(leaves, grads)))
    close_tree(got, unflatten(ref), 2e-3, "grads")
    assert all(ref[k].abs().max() > 0 for k in ref)


@pytest.mark.heavy
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(train_pair, grad_accum):
    """One whole make_train_step step (clipping, Prodigy; with grad_accum 2
    the accumulation over micro-batches) against JAX's jitted step, with the
    draws of JAX's key splits: loss, d and every trainable leaf. Then the
    JAX state after its step, carried across by from_jax_train_state, holds
    the same Prodigy trees and scalars as the port's own."""
    tp = train_pair
    jcfg = jts.TrainConfig(grad_accum=grad_accum, lr_total_steps=None)
    cfg = tts.TrainConfig(grad_accum=grad_accum, lr_total_steps=None)
    jstate = {"trainable": tp["jtrainable"],
              "opt_state": jts.make_optimizer(jcfg).init(tp["jtrainable"]),
              "step": jnp.zeros([], jnp.int32)}
    batch = jax_batch(1, grad_accum, 1)
    rng = jax.random.key(5)
    jnew, jm = jax.jit(jts.make_train_step(tp["jpipe"], jcfg))(
        jstate, tp["jfrozen"], jax.tree.map(jnp.asarray, batch), rng)
    draws = []
    for _ in range(grad_accum):
        rng, r = jax.random.split(rng)
        draws.append(jax_draws(r, 1))

    state = from_jax_train_state(jax.tree.map(np.asarray, jstate), "cpu")
    assert state["step"] == 0 and state["opt_state"]["step"] == 0
    new, m = tts.make_train_step(tp["pipe"], cfg)(state, tp["frozen"], port_batch(batch), draws)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["d"].item(), float(jm["d"]), rtol=1e-5)
    assert new["step"] == 1
    # the update is d * lr * bias-correction * m / sqrt(v) per element, about
    # 1e-6 here: hold each leaf's change to 1e-3 of its largest change, plus
    # two fp32 ulps of the leaf's largest value (the changes are read as
    # differences of fp32 params)
    old = flatten(state["trainable"])
    jnew_t = flatten(from_jax_params(jax.tree.map(np.asarray, jnew["trainable"]), "cpu"))
    ulps = {k: 2 * torch.finfo(torch.float32).eps * v.abs().max().item() + 1e-12
            for k, v in old.items()}
    ours = unflatten({k: v - old[k] for k, v in flatten(new["trainable"]).items()})
    close_tree(ours, unflatten({k: v - old[k] for k, v in jnew_t.items()}), 1e-3, "updates",
               ulps)
    carried = from_jax_train_state(jax.tree.map(np.asarray, jnew), "cpu")
    assert carried["step"] == 1 and carried["opt_state"]["step"] == 1
    for key in ("d", "d_max", "d_numerator"):
        np.testing.assert_allclose(new["opt_state"][key].item(),
                                   carried["opt_state"][key].item(), rtol=1e-5, atol=1e-30)
    for key in ("exp_avg", "exp_avg_sq", "s"):
        close_tree(new["opt_state"][key], carried["opt_state"][key], 2e-3, key)
    close_tree(new["opt_state"]["p0"], carried["opt_state"]["p0"], 0, "p0")


@pytest.mark.heavy
def test_remat_step_equals_plain_step(train_pair):
    """remat (torch.utils.checkpoint around each micro-batch loss) recomputes
    the same activations: the same loss and trainables."""
    tp = train_pair
    batch = port_batch(jax_batch(2, 2, 1))
    draws = tts.sample_draws(tp["pipe"], tts.TrainConfig(), batch,
                             torch.Generator().manual_seed(3))
    outs = []
    for remat in (False, True):
        cfg = tts.TrainConfig(grad_accum=2, remat=remat)
        state = {"trainable": tp["trainable"], "step": 0,
                 "opt_state": tts.make_optimizer(cfg).init(tp["trainable"])}
        outs.append(tts.make_train_step(tp["pipe"], cfg)(state, tp["frozen"], batch, draws))
    (a, ma), (b, mb) = outs
    assert ma["loss"].item() == mb["loss"].item()
    close_tree(a["trainable"], b["trainable"], 0, "remat")


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


@pytest.mark.parametrize("flags", [["--dataset_dir", "d", "--random_init"], [],
                                   ["--random_init", "--validation_steps", "5"],
                                   ["--random_init", "--dataloader_num_workers", "2"]])
def test_train_main_refuses_unported_flags(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_app.main(flags, device="cpu", base_cfg=TRAIN_CFG)

"""Whole-trainer parity of the PyTorch port's ControlLoRA trainer with the
JAX package's, on the CPU in fp32 at the TINY test configs: the fresh
trainables' structure, one micro-batch's loss and every trainable gradient,
whole train steps (with and without gradient accumulation) and remat.

These are the trainer's long parity tests. They live apart from
``test_torch_training.py`` so that a run giving each file one worker
(``--dist loadfile``) runs the two side by side, and they share the JAX and
port states of one module-scoped fixture (``train_pair``).

The same numpy inputs, weights and random draws go through both sides: the
JAX trainer draws its noise from ``jax.random`` keys inside the loss, so
these tests make the same draws from the same key splits and hand them to
the port's loss, which takes its draws as arguments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu.schedulers import ddpm as jddpm
from edgestyle_tpu.training import train_step as jts
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.core.porting import from_jax_params, from_jax_train_state
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.schedulers import ddpm
from edgestyle_tpu_torch.training import train_step as tts
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import perturb, port
from tests.test_torch_ops import nchw
from tests.test_torch_pipeline import TINY_PIPE
from tests.test_torch_training import H, close_tree
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)


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
    noise, so every trainable gradient is live. Built once for the module;
    JAX's init_trainable runs jitted (the same values as eager)."""
    rng = np.random.default_rng(0)
    jpipe = JPipeline(J_TINY_PIPE, attn_impl="xla")
    params = perturb(jpipe.init_params(jax.random.key(0)), rng)
    frozen = {"vae": params["vae"], "clip": params["clip"], "unet": params["unet"],
              "static": params["controlnet"]["static"]}
    init_trainable = jax.jit(lambda r, unet: jts.init_trainable(jpipe, r, unet, lora_rank=4))
    trainable = perturb(init_trainable(jax.random.key(1), params["unet"]), rng)
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
    gradient of every trainable leaf against jax.value_and_grad (jitted, as
    JAX's train step runs it), with JAX's own draws. fp32 on both sides:
    1e-5 relative on the loss, 2e-3 of each leaf's largest gradient
    (convolutions and attention sum in another order, and the gradients are
    small differences of large terms)."""
    tp = train_pair
    jcfg = jts.TrainConfig()
    batch = jax_batch(0, 1, 2)
    mb = jax.tree.map(lambda a: jnp.asarray(a[0]), batch)
    r = jax.random.key(11)
    loss_and_grads = jax.jit(lambda trainable, frozen, mb, r: jax.value_and_grad(
        jts.controlnet_loss_fn, has_aux=True)(trainable, frozen, tp["jpipe"],
                                              jddpm.NoiseSchedule.sd15(), jcfg, mb, r))
    (jloss, _), jgrads = loss_and_grads(tp["jtrainable"], tp["jfrozen"], mb, r)
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

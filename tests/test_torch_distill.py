"""Parity of the PyTorch port's LCM-LoRA distiller (training/distill.py,
apps/distill.py) and DDIM sampler with the JAX package's, on the CPU in
fp32 at the TINY test configs: DDIM's timesteps and step, the adapter set
and its layout across the two packages, one micro-batch's loss and every
adapter gradient in both modes, a whole step with gradient accumulation
and an EMA target, the ValueErrors, the ``--w_max`` rule and the entry
point's export read by the JAX package.

The same numpy inputs, weights and random draws go through both sides: the
JAX loss draws its noise from ``jax.random`` keys, so these tests make the
same draws from the same key splits and hand them to the port's loss,
which takes its draws as arguments. The weights are the port's own TINY
init moved to the JAX layout with ``to_jax_params`` and perturbed (JAX's
own init would add ~25 s), shared by the module's tests; three JAX programs
are compiled (the two modes' loss and gradients, and one step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.apps import distill as japp
from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu.schedulers.ddim import DDIMScheduler as JDDIM
from edgestyle_tpu.schedulers.ddpm import NoiseSchedule as JSchedule
from edgestyle_tpu.training import checkpoint as jckpt
from edgestyle_tpu.training import distill as jdist
from edgestyle_tpu_torch.apps import distill as app
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.models.unet import merge_lora
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.schedulers import DDIMScheduler, NoiseSchedule
from edgestyle_tpu_torch.training import checkpoint
from edgestyle_tpu_torch.training import distill as tdist
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import perturb, port
from tests.test_torch_ops import nchw
from tests.test_torch_pipeline import TINY_PIPE
from tests.test_torch_training import TRAIN_CFG, close_tree
from tests.test_torch_training_parity import H, jax_batch, port_batch
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

RANK = 4
J_SCHED = JSchedule.sd15()


# ------------------------------------------------------------------ DDIM
@pytest.mark.parametrize("spacing", ["leading", "linspace"])
def test_ddim_timesteps_match_jax(spacing):
    """Host int64, equal to JAX's (at 31, 61 and 83 steps "linspace" lands
    on x.5 ties, which JAX's float32 linspace breaks by its rounding
    errors; the port's copy of its arithmetic agreed at every count 1-1000
    when it was written)."""
    ours, ref = DDIMScheduler(NoiseSchedule.sd15()), JDDIM(J_SCHED)
    for n in (1, 2, 4, 20, 25, 31, 50, 61, 83, 999, 1000):
        ts = ours.timesteps(n, spacing)
        assert ts.dtype == np.int64
        np.testing.assert_array_equal(ts, np.asarray(ref.timesteps(n, spacing)), err_msg=str(n))
    with pytest.raises(ValueError):
        ours.timesteps(10, "trailing")


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_step_matches_jax(rng, prediction_type):
    """Steps from 999 down the leading grid to t_prev = -1 (alpha_bar = 1):
    within 1e-6 of JAX's on the same fp32 inputs."""
    ours = DDIMScheduler(NoiseSchedule.sd15(prediction_type=prediction_type))
    ref = JDDIM(dataclasses.replace(J_SCHED, prediction_type=prediction_type))
    sample = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    out = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    for t, t_prev in ((999, 899), (500, 480), (20, 0), (0, -1)):
        got = ours.step(torch.from_numpy(out), t, t_prev, torch.from_numpy(sample))
        want = ref.step(jnp.asarray(out), t, t_prev, jnp.asarray(sample))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ----------------------------------------------------------- shared set-up
@pytest.fixture(scope="module")
def distill_pair():
    """The TINY pipeline's weights, the port's init moved to the JAX layout
    and perturbed with numpy noise; rank-4 adapters and an EMA copy, both
    perturbed too, so every adapter gradient (ups included) is live; the
    unconditional context, from the port's CLIP on ids in TINY's
    vocabulary, handed to both sides."""
    rng = np.random.default_rng(0)
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    gen = make_generator(0, "cpu")
    jparams = perturb(to_jax_params(pipe.init_params(gen)), rng)
    params = port(jparams)
    lora = tdist.init_unet_lora_params(gen, params["unet"], RANK)
    jlora = perturb(to_jax_params(lora), rng)
    jtarget = perturb(jlora, rng, 0.02)
    ids = torch.from_numpy(rng.integers(1, 99, (1, TINY_PIPE.clip.max_positions)))
    with torch.no_grad():
        uctx = pipe.clip(params["clip"], ids)["last_hidden_state"]

    def frozen_of(p):
        return {"vae": p["vae"], "clip": p["clip"], "unet": p["unet"],
                "static": p["controlnet"]["static"], "controlnet": p["controlnet"]}

    return dict(jpipe=JPipeline(J_TINY_PIPE, attn_impl="xla"), pipe=pipe, jparams=jparams,
                params=params, jfrozen=frozen_of(jparams), frozen=frozen_of(params),
                jlora=jlora, lora=port(jlora), jtarget=jtarget, target=port(jtarget),
                juctx=uctx.numpy(), uctx=uctx)


def jax_distill_draws(r, b, cfg):
    """The draws JAX's distill_loss_fn makes from its key ``r``
    (distill.py:199: split into vae, noise, idx, w, swap, cond), for the
    port's loss: NCHW noise, int64 idx, (b, 1, 1, 1) w, bool flips."""
    r_vae, r_noise, r_idx, r_w, r_swap, r_cond = jax.random.split(r, 6)
    hi = cfg.num_ddim_timesteps if cfg.mode == "consistency" else J_SCHED.num_train_timesteps
    return {
        "vae_eps": nchw(jax.random.normal(r_vae, (b, H, H, 4), jnp.float32)),
        "cond_eps": nchw(jax.random.normal(r_cond, (3 * b, H, H, 4), jnp.float32)),
        "noise": nchw(jax.random.normal(r_noise, (b, H, H, 4), jnp.float32)),
        "idx": torch.from_numpy(np.array(jax.random.randint(r_idx, (b,), 0, hi))).long(),
        "w": torch.from_numpy(np.array(jax.random.uniform(
            r_w, (b, 1, 1, 1), jnp.float32, cfg.w_min, cfg.w_max))),
        "flip": torch.from_numpy(np.array(
            jax.random.bernoulli(r_swap, cfg.swap_prob, (b, 1, 1, 1))).reshape(b)),
    }


def port_cfg(jcfg):
    return tdist.DistillConfig(**dataclasses.asdict(jcfg))


# ------------------------------------------------------------ the adapters
def test_lora_targets_and_shapes_match_jax(distill_pair):
    """The predicate agrees with JAX's on every UNet path, and the fresh
    set has JAX's paths (up blocks included) and shapes in the port's
    layout (JAX's tree shaped by jax.eval_shape, moved by from_jax_params),
    fp32, ups zero."""
    dp = distill_pair
    paths = list(flatten(dp["params"]["unet"]))
    assert [tdist.is_unet_lora_linear_path(p) for p in paths] == [
        jdist.is_unet_lora_linear_path(p) for p in paths]
    shapes = jax.eval_shape(lambda: jdist.init_unet_lora_params(
        jax.random.key(0), dp["jparams"]["unet"], RANK))
    ref = flatten(from_jax_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes),
                                  "cpu"))
    got = flatten(tdist.init_unet_lora_params(make_generator(1, "cpu"), dp["params"]["unet"],
                                              RANK))
    assert got.keys() == ref.keys()
    assert {k[0] for k in got} >= {"up_blocks_0", "up_blocks_1", "mid_block", "time_embedding"}
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.shape == ref[k].shape, k
        if k[-1] == "up":
            assert v.abs().max() == 0, k


def test_lcm_lora_tree_round_trips_between_the_packages(distill_pair):
    """JAX's (in, r) down and (r, out) up become the port's (r, in) and
    (out, r) for every target path, and to_jax_params gives JAX's tree back
    bit for bit."""
    dp = distill_pair
    jl, pl = flatten(dp["jlora"]), flatten(dp["lora"])
    assert jl.keys() == pl.keys()
    for k, v in jl.items():
        np.testing.assert_array_equal(pl[k].numpy(), v.T)
    back = flatten(to_jax_params(dp["lora"]))
    assert back.keys() == jl.keys()
    for k, v in jl.items():
        np.testing.assert_array_equal(back[k], v)


def test_fresh_adapters_leave_the_unet_output_unchanged(distill_pair, rng):
    dp = distill_pair
    unet = dp["params"]["unet"]
    fresh = tdist.init_unet_lora_params(make_generator(2, "cpu"), unet, RANK)
    x = torch.from_numpy(rng.standard_normal((1, 4, H, H)).astype(np.float32))
    t = torch.tensor([500])
    ctx = dp["uctx"]
    with torch.no_grad():
        a = dp["pipe"].unet(unet, x, t, ctx)
        b = dp["pipe"].unet(tdist.apply_lcm_lora(unet, fresh), x, t, ctx)
    assert torch.equal(a, b)


# ------------------------------------------------------------- loss, grads
LOSS_CASES = {
    "consistency_ema": jdist.DistillConfig(lora_rank=RANK, ema_decay=0.95),
    "guidance": jdist.DistillConfig(lora_rank=RANK, mode="guidance", w_min=4.0, w_max=4.0,
                                    loss_type="l2"),
}


@pytest.mark.heavy
@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_distill_loss_and_grads_match_jax(distill_pair, case):
    """One micro-batch of 2 (the swap flips per sample): the loss and every
    adapter's gradient against jax.value_and_grad(distill_loss_fn)
    (jitted, as JAX's step runs it), with JAX's own draws; consistency mode
    with an EMA target (pseudo-Huber), guidance mode with L2. fp32 on both
    sides: 1e-5 relative on the loss, 2e-3 of each leaf's largest
    gradient."""
    dp = distill_pair
    jcfg = LOSS_CASES[case]
    cfg = port_cfg(jcfg)
    target = dp["target"] if jcfg.ema_decay is not None else None
    batch = jax_batch(3, 1, 2)
    mb = jax.tree.map(lambda a: jnp.asarray(a[0]), batch)
    r = jax.random.key(7)
    loss_and_grads = jax.jit(lambda lora, tgt, frozen, mb, uctx, r: jax.value_and_grad(
        jdist.distill_loss_fn, has_aux=True)(lora, tgt, frozen, dp["jpipe"], J_SCHED, jcfg, mb,
                                             uctx, r))
    (jloss, _), jgrads = loss_and_grads(
        dp["jlora"], dp["jtarget"] if target is not None else None, dp["jfrozen"], mb,
        dp["juctx"], r)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flatten(dp["lora"]).items()}
    loss = tdist.distill_loss_fn(unflatten(leaves), target, dp["frozen"], dp["pipe"],
                                 NoiseSchedule.sd15().to("cpu"), cfg,
                                 {k: v[0] for k, v in port_batch(batch).items()}, dp["uctx"],
                                 jax_distill_draws(r, 2, jcfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ref = flatten(from_jax_params(jax.tree.map(np.asarray, jgrads), "cpu"))
    close_tree(unflatten(dict(zip(leaves, grads))), unflatten(ref), 2e-3, "grads")
    assert all(ref[k].abs().max() > 0 for k in ref)


@pytest.mark.heavy
def test_distill_step_matches_jax(distill_pair):
    """One whole make_distill_step with grad_accum 2 and an EMA target
    against JAX's jitted step, with the draws of JAX's key splits: the
    loss, every adapter's change (1e-3 of each leaf's largest change plus
    two fp32 ulps of the leaf's largest value, as the trainer's step test
    holds them) and the EMA target (1e-6 of its largest value).

    AdamW's first step is lr g / (|g| + eps). At the default eps (1e-8) that
    is ~lr sign(g), and an element whose gradient is within roundoff of zero
    takes either sign on either side (TINY's 32-channel blocks, one channel
    per GroupNorm group, cancel their time-embedding projections, so those
    adapters' gradients are roundoff, ~1e-9): the update would be a
    coin-flip. With eps = 1, above every |g|, the update is within a factor
    of two of lr g and agrees as the gradients do; lr = 1 keeps it far
    above the ulps, and a max_grad_norm of 0.1 makes the clipping scale
    the gradients."""
    dp = distill_pair
    jcfg = jdist.DistillConfig(lora_rank=RANK, ema_decay=0.95, grad_accum=2, learning_rate=1.0,
                               adam_epsilon=1.0, max_grad_norm=0.1)
    cfg = port_cfg(jcfg)
    jstate = {"lcm_lora": dp["jlora"], "target": dp["jtarget"],
              "opt_state": jdist.make_distill_optimizer(jcfg).init(dp["jlora"]),
              "step": jnp.zeros([], jnp.int32)}
    batch = jax_batch(4, 2, 1)
    rng = jax.random.key(9)
    jnew, jm = jax.jit(jdist.make_distill_step(dp["jpipe"], jcfg))(
        jstate, dp["jfrozen"], jax.tree.map(jnp.asarray, batch), dp["juctx"], rng)
    draws = []
    for _ in range(2):
        rng, r = jax.random.split(rng)
        draws.append(jax_distill_draws(r, 1, jcfg))
    state = {"lcm_lora": dp["lora"], "target": dp["target"], "step": 0,
             "opt_state": tdist.make_distill_optimizer(cfg).init(dp["lora"])}
    new, m = tdist.make_distill_step(dp["pipe"], cfg)(state, dp["frozen"], port_batch(batch),
                                                      dp["uctx"], draws)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert new["step"] == 1 and int(jnew["step"]) == 1 and new["opt_state"]["count"] == 1
    old = flatten(dp["lora"])
    jnew_l = flatten(from_jax_params(jax.tree.map(np.asarray, jnew["lcm_lora"]), "cpu"))
    ulps = {k: 2 * torch.finfo(torch.float32).eps * v.abs().max().item() + 1e-12
            for k, v in old.items()}
    close_tree(unflatten({k: v - old[k] for k, v in flatten(new["lcm_lora"]).items()}),
               unflatten({k: v - old[k] for k, v in jnew_l.items()}), 1e-3, "updates", ulps)
    close_tree(new["target"], from_jax_params(jax.tree.map(np.asarray, jnew["target"]), "cpu"),
               1e-6, "ema target")


# ------------------------------------------------------------ ValueErrors
def test_guidance_mode_needs_a_pinned_w(distill_pair):
    jcfg = jdist.DistillConfig(mode="guidance", w_min=3.0, w_max=15.0)
    with pytest.raises(ValueError, match="pinned CFG scale") as jerr:
        jdist.make_distill_step(distill_pair["jpipe"], jcfg)
    with pytest.raises(ValueError, match="pinned CFG scale") as err:
        tdist.make_distill_step(distill_pair["pipe"], port_cfg(jcfg))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("field,value,message", [
    ("mode", "progressive", "unknown distill mode 'progressive'"),
    ("loss_type", "l1", "unknown loss_type 'l1'"),
])
def test_unknown_mode_and_loss_type_raise(distill_pair, field, value, message):
    """The JAX loss's messages (distill.py:327, :334); the port raises before
    any model runs."""
    dp = distill_pair
    cfg = dataclasses.replace(tdist.DistillConfig(lora_rank=RANK), **{field: value})
    batch = {k: v[0] for k, v in port_batch(jax_batch(0, 1, 1)).items()}
    draws = tdist.sample_distill_draws(dp["pipe"], tdist.DistillConfig(), port_batch(
        jax_batch(0, 1, 1)), make_generator(0, "cpu"))[0]
    with pytest.raises(ValueError, match=message):
        tdist.distill_loss_fn(dp["lora"], None, dp["frozen"], dp["pipe"],
                              NoiseSchedule.sd15().to("cpu"), cfg, batch, dp["uctx"], draws)


# ------------------------------------------------------------- the CLI
@pytest.mark.parametrize("argv", [
    [],
    ["--distill_mode", "guidance"],
    ["--distill_mode", "guidance", "--w_min", "5.5"],
    ["--w_min", "2", "--w_max", "9"],
    ["--distill_mode", "guidance", "--w_max", "7"],
    ["--lora_rank", "16", "--num_ddim_timesteps", "25", "--loss_type", "l2", "--huber_c",
     "0.01", "--ema_decay", "0.99", "--learning_rate", "3e-4", "--adam_weight_decay", "0.01",
     "--max_grad_norm", "2", "--gradient_accumulation_steps", "4", "--use_agnostic_images"],
])
def test_distill_config_of_the_flags_matches_jax(monkeypatch, argv):
    """The DistillConfig JAX's main builds from the same flags (read where
    main hands it to init_distill_state; its weight loader stubbed), the
    --w_max rule included: w_min in guidance mode, else 15."""
    from edgestyle_tpu.core import pretrained as jpretrained

    class Built(Exception):
        pass

    def capture(pipe, rng, unet, dcfg):
        raise Built(dcfg)

    monkeypatch.setattr(jpretrained, "load_pipeline_params", lambda *a, **k: {
        "vae": 0, "clip": 0, "unet": 0, "controlnet": {"static": 0}})
    monkeypatch.setattr(jdist, "init_distill_state", capture)
    with pytest.raises(Built) as built:
        japp.main(argv)
    ours = app.distill_config(app.parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(built.value.args[0])


def test_distill_main_resumes_and_exports_for_jax(tmp_path, capsys):
    """The entry point at TINY width on the CPU, 2 steps: JSON log lines, a
    finite loss, the EMA target, the checkpoint equal to the returned state,
    a resume that continues from it; ``lcm_lora.safetensors`` reads back
    bitwise in the port and loads in JAX's import_safetensors, whose tree
    merged by JAX's apply_lcm_lora equals the port's merge (1e-6)."""
    argv = ["--random_init", "--resolution", "32", "--train_batch_size", "1",
            "--gradient_accumulation_steps", "2", "--logging_steps", "1", "--lora_rank",
            str(RANK), "--mixed_precision", "no", "--ema_decay", "0.9", "--output_dir",
            str(tmp_path)]
    out = app.main(argv + ["--max_train_steps", "2", "--checkpointing_steps", "1",
                           "--checkpoints_total_limit", "1"], device="cpu", base_cfg=TRAIN_CFG)
    assert [r["step"] for r in out["log"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in out["log"])
    assert '"done": true' in capsys.readouterr().out
    state = out["state"]
    assert set(state) == {"lcm_lora", "opt_state", "step", "target"}
    assert checkpoint.list_checkpoints(str(tmp_path)) == [2]
    assert checkpoint.states_equal(checkpoint.load_checkpoint(str(tmp_path), device="cpu"),
                                   state)
    path = str(tmp_path / "lcm_lora.safetensors")
    assert checkpoint.states_equal(checkpoint.import_safetensors(path, "cpu")["lcm_lora"],
                                   state["lcm_lora"])
    unet = out["frozen"]["unet"]
    jmerged = jdist.apply_lcm_lora(to_jax_params(unet), jckpt.import_safetensors(path)["lcm_lora"])
    close_tree(merge_lora(unet, state["lcm_lora"]),
               from_jax_params(jax.tree.map(np.asarray, jmerged), "cpu"), 1e-6, "merged")

    out2 = app.main(argv + ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"],
                    device="cpu", base_cfg=TRAIN_CFG)
    assert [r["step"] for r in out2["log"]] == [3]


def test_distill_main_refuses_unpinned_guidance_and_several_cards(monkeypatch):
    with pytest.raises(ValueError, match="pinned CFG scale"):
        app.main(["--random_init", "--resolution", "32", "--lora_rank", str(RANK),
                  "--distill_mode", "guidance", "--w_max", "7"], device="cpu",
                 base_cfg=TRAIN_CFG)
    # several cards: a micro-batch the ranks cannot share, and ranks that
    # torchrun did not start
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match=r"must be divisible by the device count \(3\)"):
        app.main(["--random_init"], device="cpu", base_cfg=TRAIN_CFG)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        app.main(["--random_init"], device="cpu", base_cfg=TRAIN_CFG)


def test_distill_build_holds_the_weights_in_fp32_with_bf16_conv_kernels():
    """Under mixed precision the frozen weights are held as JAX's distiller
    holds them: the fp32 draws of a ``--mixed_precision no`` build, norms,
    embeddings and the linears the adapters merge into unrounded; only the
    conv kernels are bf16, the rounding each conv applies at use. The
    adapters and the pipeline's compute dtype follow the flags."""
    argv = ["--random_init", "--resolution", "32", "--lora_rank", str(RANK)]
    pipe, frozen, _, state = app.build(app.parse_args(argv), "cpu", TRAIN_CFG)
    pipe32, frozen32, _, state32 = app.build(
        app.parse_args(argv + ["--mixed_precision", "no"]), "cpu", TRAIN_CFG)
    assert pipe.dtype == torch.bfloat16 and pipe32.dtype == torch.float32
    got, want = flatten(frozen), flatten(frozen32)
    assert got.keys() == want.keys()
    convs = [k for k, v in got.items() if app.is_conv_kernel(k, v)]
    assert {k[0] for k in convs} >= {"vae", "unet", "controlnet"}
    for k, v in got.items():
        if k in convs:
            assert v.dtype == torch.bfloat16 and torch.equal(v, want[k].to(torch.bfloat16)), k
        else:
            assert v.dtype == torch.float32 and torch.equal(v, want[k]), k
    assert checkpoint.states_equal(state, state32)


def test_bf16_leaves_keeps_shared_tensors_shared():
    """A tensor at several paths of the tree (the ControlLoRA branches share
    the UNet trunk's untouched leaves) is cast once, so the cast tree holds
    one copy, as the fp32 tree did; unselected and non-fp32 leaves are the
    same objects."""
    from edgestyle_tpu_torch.apps.train import bf16_leaves

    w, n, i = torch.randn(4, 4, 3, 3), torch.ones(4), torch.arange(3)
    tree = {"unet": {"conv": {"kernel": w}, "norm": {"scale": n}, "ids": i},
            "branch": {"conv": {"kernel": w}, "norm": {"scale": n}}}
    out = bf16_leaves(tree, app.is_conv_kernel)
    assert out["unet"]["conv"]["kernel"] is out["branch"]["conv"]["kernel"]
    assert out["unet"]["conv"]["kernel"].dtype == torch.bfloat16
    assert torch.equal(out["unet"]["conv"]["kernel"], w.to(torch.bfloat16))
    assert out["unet"]["norm"]["scale"] is n and out["unet"]["ids"] is i
    every = bf16_leaves(tree)
    assert every["unet"]["norm"]["scale"] is every["branch"]["norm"]["scale"]
    assert every["unet"]["norm"]["scale"].dtype == torch.bfloat16

"""The port's serving knobs against the JAX package, on the CPU in fp32 at
the TINY configs: the ToMe merge and the ToMe transformer block, the UNet's
deep feature and ``shallow_forward``, the DPM-Solver++ and LCM samplers,
the exact values of the knobs and their ValueErrors, the app's serving
presets and the LCM-LoRA merge. ``EdgeStylePipeline`` with each knob
combination against JAX's is in tests/test_torch_serving_pipeline.py (a
file of its own, so the two run on two workers).

The pipeline's weights are the port's own init (seed 0) moved to the JAX
layout (``to_jax_params``) and perturbed with numpy noise, so both sides run
the same values; the inputs come from numpy seeds.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.apps import tryon as japp
from edgestyle_tpu.models import layers as jl
from edgestyle_tpu.models.unet import SD15UNet as JUNet
from edgestyle_tpu.ops import tome as jtome
from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu.schedulers.ddpm import NoiseSchedule as JSchedule
from edgestyle_tpu.schedulers.dpmsolver import DPMSolverScheduler as JDPM
from edgestyle_tpu.schedulers.lcm import LCMScheduler as JLCM
from edgestyle_tpu.training.distill import apply_lcm_lora as j_apply_lcm_lora
from edgestyle_tpu.training.distill import init_unet_lora_params as j_init_unet_lora
from edgestyle_tpu_torch.apps import tryon
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.models import layers
from edgestyle_tpu_torch.models.unet import SD15UNet
from edgestyle_tpu_torch.ops import tome
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.dpmsolver import DPMSolverScheduler
from edgestyle_tpu_torch.schedulers.lcm import LCMScheduler
from edgestyle_tpu_torch.training.checkpoint import export_safetensors
from edgestyle_tpu_torch.training.distill import apply_lcm_lora
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import TINY, perturb, port
from tests.test_torch_ops import nchw, nhwc
from tests.test_torch_pipeline import TINY_PIPE
from tests.test_unet import TINY as J_TINY
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-4      # one fp32 module on both sides
PIPE_ATOL = 1e-3  # [0, 1] images after a few steps, as tests/test_torch_pipeline.py
LEVEL0 = 256     # tokens at the TINY UNet's 16x16 level: ToMe applies there alone


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def tome_cfgs(ratio=0.5, merge_mlp=False):
    """The same ToMe policy for both packages, lowered to the TINY level."""
    return (jtome.ToMeConfig(ratio=ratio, min_tokens=LEVEL0, merge_mlp=merge_mlp),
            tome.ToMeConfig(ratio=ratio, min_tokens=LEVEL0, merge_mlp=merge_mlp))


# -------------------------------------------------------------------- ToMe
MERGE_CASES = {  # h, w, r, dtype
    "r0": (8, 8, 0, "float32"),
    "square": (16, 16, 64, "float32"),
    "wide": (12, 16, 50, "float32"),
    "cap_at_3n_over_4": (16, 16, 1000, "float32"),
    "bf16": (32, 32, 512, "bfloat16"),
}


def _rows(unmerge, b, n_merged, n):
    """The row each position reads, through unmerge of the row numbers."""
    y = torch.arange(n_merged, dtype=torch.float64)[None, :, None].expand(b, -1, 1)
    out = unmerge(y)[..., 0]
    assert out.shape == (b, n)
    return out.numpy()


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_build_merge_matches_jax(case, rng):
    """merge, unmerge and r against edgestyle_tpu/ops/tome.py::build_merge on
    the same metric: the row indices equal (no flipped rank), the merged
    and unmerged values within 1e-6 (exact in fp32 here; bf16 values
    equal)."""
    h, w, r, dt = MERGE_CASES[case]
    x = randn(rng, 2, h * w, 24)
    jx = jnp.asarray(x, getattr(jnp, dt))
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    jm, ju, jr = jtome.build_merge(jx, h, w, r)
    m, u, r_eff = tome.build_merge(tx, h, w, r)
    assert r_eff == jr == min(r, 3 * h * w // 4)
    n = h * w
    jy = np.asarray(jm(jx), np.float32)
    y = m(tx)
    assert tuple(y.shape) == jy.shape == (2, n - r_eff, 24)
    np.testing.assert_allclose(y.float().numpy(), jy, atol=1e-6)
    jrows = np.asarray(ju(jnp.arange(n - r_eff, dtype=jnp.float32)[None, :, None]
                          .repeat(2, 0)))[..., 0]
    np.testing.assert_array_equal(_rows(u, 2, n - r_eff, n), jrows)
    np.testing.assert_allclose(u(y).float().numpy(), np.asarray(ju(jm(jx)), np.float32),
                               atol=1e-6)


@pytest.mark.parametrize("distinct", [1, 4])
def test_build_merge_identical_tokens_roundtrip(distinct, rng):
    """Tokens drawn from 1 or 4 distinct vectors: every score ties with
    others, so the rows hold JAX's tie order (its stable argsort, the first
    maximum) only if they equal JAX's; every merge joins equal tokens, so
    unmerge(merge(x)) gives x back within an fp32 mean's rounding (1e-6),
    as JAX's does."""
    base = randn(rng, distinct, 24)
    x = base[rng.integers(0, distinct, size=(2, 256))]
    m, u, r = tome.build_merge(torch.from_numpy(x), 16, 16, 128)
    assert r == 128
    np.testing.assert_allclose(u(m(torch.from_numpy(x))).numpy(), x, rtol=1e-6, atol=1e-6)
    jm, ju, _ = jtome.build_merge(jnp.asarray(x), 16, 16, 128)
    jrows = np.asarray(ju(jnp.arange(128, dtype=jnp.float32)[None, :, None].repeat(2, 0)))[..., 0]
    np.testing.assert_array_equal(_rows(u, 2, 128, 256), jrows)


@pytest.mark.parametrize("merge_mlp", [False, True])
def test_transformer_block_tome_matches_jax(merge_mlp, rng):
    """BasicTransformerBlock with ToMe at the 16x16 level (min_tokens lowered
    to 256) against the port's transformer_block on the same params, input
    and context; below min_tokens both run the exact block."""
    jcfg, cfg = tome_cfgs(0.5, merge_mlp)
    x, ctx = randn(rng, 2, 256, 32), randn(rng, 2, 7, 24)
    mod = jl.BasicTransformerBlock(num_heads=2, attn_impl="xla", tome=jcfg)
    init = jax.jit(mod.init, static_argnames="hw")
    params = perturb(init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx),
                          hw=(16, 16))["params"], rng)
    ref = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx), hw=(16, 16))
    p = port(params)
    out = layers.transformer_block(p, torch.from_numpy(x), torch.from_numpy(ctx), 2,
                                   torch.float32, hw=(16, 16), tome=cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)
    exact = layers.transformer_block(p, torch.from_numpy(x), torch.from_numpy(ctx), 2,
                                     torch.float32)
    assert (exact - out).abs().max() > 1e-3  # the merge changed the block
    above = tome.ToMeConfig(ratio=0.5, min_tokens=257, merge_mlp=merge_mlp)
    assert torch.equal(layers.transformer_block(p, torch.from_numpy(x), torch.from_numpy(ctx),
                                                2, torch.float32, hw=(16, 16), tome=above),
                       exact)


# ------------------------------------------------------------ shallow UNet
@pytest.fixture(scope="module")
def pipe_params():
    """The port's TINY init (seed 0) in the JAX layout, perturbed with numpy
    noise so the zero-init heads are live."""
    tp = EdgeStylePipeline(TINY_PIPE, device="cpu").init_params(make_generator(0, "cpu"))
    return perturb(to_jax_params(tp), np.random.default_rng(0))


@pytest.fixture(scope="module")
def unet_pair(pipe_params):
    return JUNet(J_TINY, attn_impl="xla"), pipe_params["unet"]


def _unet_inputs(rng):
    x = randn(rng, 2, 16, 16, 4)
    t = np.array([10, 500], np.int64)
    ctx = randn(rng, 2, 7, 24)
    shapes = [(2, 16, 16, 32), (2, 16, 16, 32), (2, 8, 8, 32), (2, 8, 8, 64)]
    down = [0.01 * randn(rng, *s) for s in shapes]
    return x, t, ctx, down, 0.01 * randn(rng, 2, 8, 8, 64)


def test_shallow_forward_matches_jax(unet_pair, rng):
    """return_deep's feature and shallow_forward (on a deep feature taken at
    another step) against JAX's, within 1e-4."""
    j, params = unet_pair
    x, t, ctx, down, mid = _unet_inputs(rng)
    jdown = [jnp.asarray(d) for d in down]
    ref, jdeep = j.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                         down_block_additional_residuals=jdown,
                         mid_block_additional_residual=jnp.asarray(mid), return_deep=True)
    x2 = randn(rng, 2, 16, 16, 4)
    jshallow = j.apply({"params": params}, jnp.asarray(x2), jnp.asarray(t + 20),
                       jnp.asarray(ctx), jdeep, down_block_additional_residuals=jdown,
                       method="shallow_forward")
    unet, p = SD15UNet(TINY), port(params)
    tdown = [nchw(d) for d in down]
    out, deep = unet(p, nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                     down_block_additional_residuals=tdown,
                     mid_block_additional_residual=nchw(mid), return_deep=True)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(nhwc(deep), np.asarray(jdeep), atol=ATOL, rtol=1e-4)
    shallow = unet.shallow_forward(p, nchw(x2), torch.from_numpy(t + 20), torch.from_numpy(ctx),
                                   nchw(np.asarray(jdeep)), down_block_additional_residuals=tdown)
    np.testing.assert_allclose(nhwc(shallow), np.asarray(jshallow), atol=ATOL, rtol=1e-4)


def test_shallow_forward_exactness(unet_pair, rng):
    """With the deep feature captured at the same (sample, t), shallow_forward
    returns __call__'s output bit for bit (tests/test_unet.py's property),
    also under ToMe; a ControlNet refuses it."""
    _, params = unet_pair
    x, t, ctx, down, mid = _unet_inputs(rng)
    p = port(params)
    for unet in (SD15UNet(TINY), SD15UNet(TINY, tome=tome_cfgs()[1])):
        args = (nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
        out, deep = unet(p, *args, down_block_additional_residuals=[nchw(d) for d in down],
                         mid_block_additional_residual=nchw(mid), return_deep=True)
        assert deep.shape == (2, 64, 16, 16)
        shallow = unet.shallow_forward(p, *args, deep,
                                       down_block_additional_residuals=[nchw(d) for d in down])
        assert torch.equal(shallow, out)
        assert torch.equal(out, unet(p, *args, down_block_additional_residuals=[
            nchw(d) for d in down], mid_block_additional_residual=nchw(mid)))
    with pytest.raises(ValueError, match="not a ControlNet"):
        SD15UNet(TINY, controlnet_mode=True).shallow_forward(p, *args, deep)


# ---------------------------------------------------------------- samplers
@pytest.mark.parametrize("steps", [1, 2, 5, 20])
def test_dpm_plan_and_trajectory_match_jax(steps):
    """DPM-Solver++ 2M: the plan's timesteps and order table equal JAX's, its
    float tables within fp32 rounding (2e-6: the two packages' alpha-bar
    tables differ by an ulp, and their logs by 1e-6), and a trajectory of a smooth model
    function through both samplers within 2e-4 (the UniPC test's)."""
    ours, ref = DPMSolverScheduler(NoiseSchedule.sd15()), JDPM(JSchedule.sd15())
    plan, jplan = ours.plan(steps), ref.plan(steps)
    np.testing.assert_array_equal(plan.timesteps, np.asarray(jplan.timesteps))
    np.testing.assert_array_equal(plan.order, np.asarray(jplan.order))
    for f in ("lambda_s0", "lambda_s1", "lambda_t", "alpha_t", "sigma_t", "alpha_s0",
              "sigma_s0"):
        np.testing.assert_allclose(getattr(plan, f), np.asarray(getattr(jplan, f)), rtol=2e-6,
                                   atol=2e-6, err_msg=f)
    x0 = np.random.default_rng(steps).standard_normal((2, 4, 8, 8)).astype(np.float32)

    def jmodel(sample, t):
        return 0.9 * sample * jnp.cos(t.astype(jnp.float32) / 311.0) + 0.1

    def model(sample, t, i):
        return 0.9 * sample * float(np.cos(np.float32(t) / np.float32(311.0))) + 0.1

    jfinal = np.asarray(jax.jit(lambda x: ref.sample_loop(jplan, jmodel, x))(jnp.asarray(x0)))
    final = ours.sample_loop(plan, model, torch.from_numpy(x0)).numpy()
    assert np.isfinite(final).all()
    np.testing.assert_allclose(final, jfinal, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("steps", [1, 2, 4, 8])
def test_lcm_grid_plan_and_steps_match_jax(steps):
    """LCM: the timestep grid equals JAX's, the plan's tables within fp32
    rounding (2e-6); each step,
    fed JAX's own re-noise normal(fold_in(key, i)), within 1e-5; the last
    step returns the estimate and draws nothing (a plan without a
    generator)."""
    ours, ref = LCMScheduler(NoiseSchedule.sd15()), JLCM(JSchedule.sd15())
    np.testing.assert_array_equal(ours.timestep_grid(steps), ref.timestep_grid(steps))
    key = jax.random.key(5)
    plan, jplan = ours.plan(steps), ref.plan(steps, rng=key)
    np.testing.assert_array_equal(plan.timesteps, np.asarray(jplan.timesteps))
    for f in ("alpha_s", "sigma_s", "alpha_p", "sigma_p", "c_skip", "c_out"):
        np.testing.assert_allclose(getattr(plan, f), np.asarray(getattr(jplan, f)), rtol=2e-6,
                                   atol=2e-6, err_msg=f)
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(steps):
        eps = rng.standard_normal(x.shape).astype(np.float32)
        jx, _ = ref.step(jplan, jnp.int32(i), jnp.asarray(eps), jx, {})
        noise = np.array(jax.random.normal(jax.random.fold_in(key, i), x.shape, jnp.float32))
        last = i == steps - 1
        tx, _ = ours.step(plan, i, torch.from_numpy(eps), tx, {},
                          noise=None if last else torch.from_numpy(noise))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    if steps > 1:
        with pytest.raises(ValueError, match="generator"):
            ours.step(plan, 0, torch.from_numpy(x), torch.from_numpy(x), {})
        gen = make_generator(0, "cpu")
        a, _ = ours.step(ours.plan(steps, gen), 0, torch.from_numpy(x), torch.from_numpy(x), {})
        assert torch.isfinite(a).all()


# ---------------------------------------------------------------- pipeline
def _pipe_inputs(seed, b=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 99, size=(b, 7))
    neg = rng.integers(1, 99, size=(b, 7))
    imgs = [(rng.standard_normal((b, 32, 32, 3)) * 0.5).astype(np.float32) for _ in range(6)]
    return ids, neg, imgs, rng.standard_normal((b, 16, 16, 4)).astype(np.float32)


TURBO = dict(cfg_interval=(0.0, 0.4), controlnet_cache_interval=3, unet_cache_interval=2)


def test_exact_knob_values_run_the_exact_program(pipe_params):
    """Intervals of 1, steps covering every step, cfg_interval (0, 1), ToMe 0
    and the UniPC scheduler give the exact image bit for bit."""
    ids, neg, imgs, lat = _pipe_inputs(2)
    p = from_jax_params(pipe_params, device="cpu")
    args = (p, torch.from_numpy(ids), torch.from_numpy(neg), [nchw(im) for im in imgs])
    exact = EdgeStylePipeline(TINY_PIPE, device="cpu")(*args, latents=nchw(lat),
                                                       num_inference_steps=3)
    knobs = EdgeStylePipeline(dataclasses.replace(TINY_PIPE, scheduler="unipc"), device="cpu",
                              tome=0.0)
    out = knobs(*args, latents=nchw(lat), num_inference_steps=3, controlnet_cache_interval=1,
                unet_cache_interval=1, cfg_interval=(0, 1), controlnet_cache_steps=(0, 1, 2),
                unet_cache_steps=range(3))
    assert torch.equal(out, exact)


BAD_KNOBS = [
    dict(controlnet_cache_interval=0), dict(unet_cache_interval=1.5),
    dict(controlnet_cache_interval="2"), dict(cfg_interval=(-0.1, 1.0)),
    dict(cfg_interval=(1.0, 0.0)), dict(cfg_interval=0.5), dict(cfg_interval=(0.2,)),
    dict(controlnet_cache_steps=(1, 2)), dict(unet_cache_steps=(0, 4)),
    dict(controlnet_cache_steps=("a", "b")), dict(unet_cache_steps=()),
    dict(controlnet_cache_steps=(0, 2), controlnet_cache_interval=2),
]


@pytest.mark.parametrize("kw", BAD_KNOBS, ids=[str(k) for k in BAD_KNOBS])
def test_knob_value_errors_match_jax(kw, pipe_params):
    """A bad knob raises the JAX pipeline's ValueError, message for message,
    before any input is read."""
    ids, neg, imgs, _ = _pipe_inputs(3)
    jpipe = JPipeline(J_TINY_PIPE, attn_impl="xla")
    with pytest.raises(ValueError) as jerr:
        jpipe(pipe_params, jnp.asarray(ids, jnp.int32), jnp.asarray(neg, jnp.int32),
              [jnp.asarray(im) for im in imgs], num_inference_steps=4, **kw)
    with pytest.raises(ValueError) as err:
        EdgeStylePipeline(TINY_PIPE, device="cpu")({}, torch.from_numpy(ids),
                                                   torch.from_numpy(neg), [],
                                                   num_inference_steps=4, **kw)
    assert str(err.value) == str(jerr.value)


def test_pipeline_knob_arguments():
    assert EdgeStylePipeline(TINY_PIPE, device="cpu", tome=0.25).tome == tome.ToMeConfig(0.25)
    assert EdgeStylePipeline(TINY_PIPE, device="cpu", tome=0).tome is None
    with pytest.raises(ValueError, match="tome"):
        EdgeStylePipeline(TINY_PIPE, device="cpu", tome="0.5")
    with pytest.raises(ValueError, match="scheduler"):
        EdgeStylePipeline(dataclasses.replace(TINY_PIPE, scheduler="ddim"), device="cpu")
    for name, cls in (("dpmsolver++", DPMSolverScheduler), ("lcm", LCMScheduler)):
        pipe = EdgeStylePipeline(dataclasses.replace(TINY_PIPE, scheduler=name), device="cpu")
        assert isinstance(pipe.scheduler, cls)


# --------------------------------------------------------------------- app
REQUIRED = ["--subject", "s.png", "--clothes1", "a.png", "--clothes2", "b.png",
            "--random_init"]
KNOBS = ("cfg_interval", "controlnet_cache_interval", "unet_cache_interval",
         "controlnet_cache_steps", "unet_cache_steps", "tome", "scheduler", "steps")
OVERRIDES = [[], ["--tome", "0", "--cfg_interval", "0", "1"],
             ["--controlnet_cache_interval", "4", "--steps", "8"],
             ["--steps", "5", "--unet_cache_steps", "0", "3"]]


def _knobs(args):
    def norm(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v
    return {k: norm(getattr(args, k)) for k in KNOBS}


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: " ".join(o) or "none")
@pytest.mark.parametrize("mode", sorted(tryon.SERVING_MODES))
def test_apply_serving_mode_matches_jax(mode, overrides):
    """Every preset, with and without explicit flags: the knobs after
    apply_serving_mode equal the JAX app's, and the pipeline arguments equal
    its TryOnSystem._approx_kwargs."""
    assert sorted(tryon.SERVING_MODES) == sorted(japp.SERVING_MODES)
    argv = REQUIRED + ["--mode", mode] + overrides
    ours = tryon.apply_serving_mode(tryon.parse_args(argv))
    ref = japp.apply_serving_mode(japp.parse_args(argv))
    assert _knobs(ours) == _knobs(ref)
    jsys = japp.TryOnSystem.__new__(japp.TryOnSystem)
    jsys._set_serving_knobs(ref)
    assert tryon.serving_kwargs(ours) == jsys._approx_kwargs()
    assert _knobs(tryon.apply_serving_mode(ours)) == _knobs(ref)  # idempotent


def test_apply_lcm_lora_matches_jax(pipe_params, rng):
    """Adapters over the whole UNet (the distiller's), perturbed, merged at
    scale 0.7 by both packages: every leaf within 1e-5."""
    unet = pipe_params["unet"]
    lora = j_init_unet_lora(jax.random.key(4), unet, rank=4)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape), lora)
    ref = flatten(port(j_apply_lcm_lora(unet, lora, 0.7)))
    out = flatten(apply_lcm_lora(port(unet), port(lora), 0.7))
    assert out.keys() == ref.keys()
    moved = 0
    for path, a in out.items():
        np.testing.assert_allclose(a.numpy(), ref[path].numpy(), atol=1e-5, err_msg=str(path))
        moved += any(k.startswith("up_blocks") for k in path) and "attn1" in path
    assert moved  # the up path's adapters were merged too


def _system(argv, pipe, gen_params, **kw):
    args = tryon.parse_args(REQUIRED + argv)
    return tryon.TryOnSystem(args=args, device="cpu", pipe=pipe, gen_params=gen_params, **kw)


def test_tryon_system_runs_the_presets(pipe_params, tmp_path, rng):
    """TryOnSystem with --mode turbo hands the preset's knobs to every
    generation (the pipeline call with them, bit for bit); --lcm_lora
    merges the file's adapters into the UNet; --scheduler lcm without it
    warns; a handed-in pipeline that does not run the asked sampler or
    ToMe ratio is refused."""
    p = from_jax_params(pipe_params, device="cpu")
    turbo_pipe = EdgeStylePipeline(TINY_PIPE, device="cpu", tome=0.5)
    system = _system(["--mode", "turbo"], turbo_pipe, p)
    assert system.knobs == TURBO
    ids, neg, imgs, _ = _pipe_inputs(4)
    cond = {k: np.clip(imgs[j][0] * 0.5 + 0.5, 0, 1) for j, k in enumerate(
        ("agnostic", "subject_pose", "clothes1", "clothes1_pose", "clothes2", "clothes2_pose"))}
    out = system.generate(cond, ids, neg, steps=4, seed=3)
    to_norm = lambda a: nchw(a[None] * 2.0 - 1.0)  # noqa: E731
    want = turbo_pipe(p, ids, neg, [to_norm(cond["agnostic"]), nchw(cond["subject_pose"][None]),
                                    to_norm(cond["clothes1"]), nchw(cond["clothes1_pose"][None]),
                                    to_norm(cond["clothes2"]), nchw(cond["clothes2_pose"][None])],
                      generator=make_generator(3, "cpu"), num_inference_steps=4, **TURBO)
    np.testing.assert_array_equal(out, nhwc(want)[0])

    lora = j_init_unet_lora(jax.random.key(6), pipe_params["unet"], rank=4)
    lora = port(jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape), lora))
    path = str(tmp_path / "lcm.safetensors")
    export_safetensors(path, {"lcm_lora": lora})
    lcm_pipe = EdgeStylePipeline(dataclasses.replace(TINY_PIPE, scheduler="lcm"), device="cpu")
    system = _system(["--mode", "lcm", "--lcm_lora", path], lcm_pipe, p)
    assert system.knobs == {"cfg_interval": (0.0, 0.0)}
    want = flatten(apply_lcm_lora(p["unet"], lora))
    got = flatten(system.gen_params["unet"])
    assert all(torch.allclose(got[k], want[k], atol=1e-6) for k in want)
    with pytest.warns(UserWarning, match="lcm_lora"):
        _system(["--scheduler", "lcm"], lcm_pipe, p)
    with pytest.raises(ValueError, match="does not run"):
        _system(["--mode", "conservative"], EdgeStylePipeline(TINY_PIPE, device="cpu"), p)
    assert isinstance(tryon.parse_args(REQUIRED), argparse.Namespace)

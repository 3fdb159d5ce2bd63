"""Parity of the PyTorch port's sampler and try-on pipeline with the JAX
package's, on the CPU in fp32, plus the port's package rules: no import of
JAX or of the JAX package, and entry points that refuse to run on the CPU
unless asked to.
"""

import math
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu.schedulers.ddpm import NoiseSchedule as JSchedule
from edgestyle_tpu.schedulers.unipc import UniPCScheduler as JUniPC
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.porting import from_jax_params
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig
from edgestyle_tpu_torch.models.vae import VAEConfig
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig
from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.unipc import UniPCScheduler
from tests import golden_mirror as gm
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import TINY, TINY_CLIP, TINY_VAE, perturb
from tests.test_torch_ops import nchw, nhwc

REPO = pathlib.Path(__file__).resolve().parents[1]

TINY_PIPE = PipelineConfig(unet=TINY, vae=VAEConfig(**TINY_VAE), clip=CLIPTextConfig(**TINY_CLIP),
                           dtype="float32")


# ------------------------------------------------------------------ UniPC
@pytest.mark.parametrize("steps,order", list(gm.UNIPC_CASES))
def test_unipc_trajectory_matches_jax_and_golden(steps, order):
    """The golden's model function through both samplers; host float32
    coefficients on the port's side, device fp32 on JAX's: atol 2e-4 as
    the JAX golden test."""
    ours = UniPCScheduler(NoiseSchedule.sd15(), solver_order=order)
    ref = JUniPC(JSchedule.sd15(), solver_order=order)
    plan, jplan = ours.plan(steps), ref.plan(steps)
    np.testing.assert_array_equal(plan.timesteps, np.asarray(jplan.timesteps))
    np.testing.assert_array_equal(plan.pred_order, np.asarray(jplan.pred_order))
    x0 = gm.unipc_x0().astype(np.float32)

    def jmodel(sample, t):
        return 0.9 * sample * jnp.cos(t.astype(jnp.float32) / 311.0) + 0.1

    def model(sample, t, i):
        return 0.9 * sample * float(np.cos(np.float32(t) / np.float32(311.0))) + 0.1

    jfinal = np.asarray(jax.jit(lambda x: ref.sample_loop(jplan, jmodel, x))(jnp.asarray(x0)))
    final = ours.sample_loop(plan, model, torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(final, jfinal, atol=2e-4, rtol=2e-4)
    golden = np.load(gm.GOLDENS_NPZ)
    np.testing.assert_array_equal(plan.timesteps, golden[f"unipc.{steps}_{order}.timesteps"])
    np.testing.assert_allclose(final, golden[f"unipc.{steps}_{order}.final"], atol=2e-4,
                               rtol=2e-4)


# --------------------------------------------------------------- pipeline
CASES = {
    # pattern, batch, call kwargs
    "6branch_per_sample_guidance": ((0, None, 1, None, 1, None), 2, dict(
        guidance_scale=[3.5, 7.0], conditioning_scale=[1.0, 0.5, 0.8, 1.0, 0.3, 0.9],
        control_guidance_end=[1.0, 1.0, 0.5, 1.0, 1.0, 1.0])),
    "6branch_guess_mode": ((0, None, 1, None, 1, None), 1, dict(guess_mode=True)),
    "4branch_legacy": ((0, None, 1, None), 1, dict(guidance_scale=5.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(case):
    """EdgeStylePipeline.__call__ on the same weights (JAX init, perturbed
    so heads and zero-init convs are live), ids, control images and
    latents, 2 UniPC steps: [0,1] images within 1e-3."""
    import dataclasses

    pattern, b, kwargs = CASES[case]
    rng = np.random.default_rng(0)
    jpipe = JPipeline(dataclasses.replace(J_TINY_PIPE, pattern=pattern), attn_impl="xla")
    params = perturb(jpipe.init_params(jax.random.key(0)), rng)
    ids = rng.integers(1, 99, size=(b, 7))
    neg = rng.integers(1, 99, size=(b, 7))
    imgs = [(rng.standard_normal((b, 32, 32, 3)) * 0.5).astype(np.float32) for _ in pattern]
    lat = rng.standard_normal((b, 16, 16, 4)).astype(np.float32)
    ref = jpipe(params, jnp.asarray(ids, jnp.int32), jnp.asarray(neg, jnp.int32),
                [jnp.asarray(im) for im in imgs], latents=jnp.asarray(lat),
                num_inference_steps=2, **kwargs)
    pipe = EdgeStylePipeline(dataclasses.replace(TINY_PIPE, pattern=pattern), device="cpu")
    out = pipe(from_jax_params(params, device="cpu"), torch.from_numpy(ids),
               torch.from_numpy(neg), [nchw(im) for im in imgs], latents=nchw(lat),
               num_inference_steps=2, **kwargs)
    assert out.shape == (b, 3, 32, 32)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-3)


def test_pipeline_init_and_generate_on_cpu():
    """The port's own random init drives a generation: finite [0,1] images
    whose controls change the result once the zero-init heads are set."""
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    gen = make_generator(0, "cpu")
    params = pipe.init_params(gen)
    assert params["controlnet"].keys() == {"static", "lora_0", "lora_1", "fusion"}
    head = params["controlnet"]["static"]["controlnet_mid_block"]["kernel"]
    assert head.abs().max() == 0
    ids = torch.randint(1, 99, (1, 7), generator=gen)
    imgs = [torch.randn((1, 3, 32, 32), generator=gen) for _ in range(6)]
    lat = torch.randn((1, 4, 16, 16), generator=gen)
    out = pipe(params, ids, ids, imgs, latents=lat, num_inference_steps=2)
    assert torch.isfinite(out).all() and 0 <= out.min() and out.max() <= 1 and out.std() > 0
    for key in ("static", "lora_0", "lora_1"):
        tree = params["controlnet"][key]
        for name in [k for k in tree if k.startswith("controlnet_") and k != "controlnet_cond_embedding"]:
            tree[name] = {k: torch.randn(v.shape, generator=gen) * 0.1 for k, v in tree[name].items()}
    out2 = pipe(params, ids, ids, imgs, latents=lat, num_inference_steps=2)
    assert (out2 - out).abs().max() > 1e-4


def test_pipeline_rejects_unported_knobs():
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    with pytest.raises(NotImplementedError):
        pipe({}, torch.zeros((1, 7)), torch.zeros((1, 7)), [], controlnet_cache_interval=2)
    with pytest.raises(NotImplementedError):
        pipe({}, torch.zeros((1, 7)), torch.zeros((1, 7)), [], cfg_interval=(0.0, 0.4))
    with pytest.raises(NotImplementedError):
        EdgeStylePipeline(TINY_PIPE, device="cpu", quant="int8")


# ------------------------------------------------------------ package rules
_FORBIDDEN = re.compile(
    r"(\bimport\s+(jax|flax|edgestyle_tpu)\b|\bfrom\s+(jax|flax|edgestyle_tpu)\b"
    r"|\bedgestyle_tpu\.|import_module\(\s*['\"](jax|flax|edgestyle_tpu)\b)")


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "edgestyle_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
            for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if _FORBIDDEN.search(line)]
    assert not hits, hits
    code = ("import sys, edgestyle_tpu_torch.pipelines.tryon, edgestyle_tpu_torch.kernels, "
            "edgestyle_tpu_torch.apps.tryon; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'edgestyle_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_refuse_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EdgeStylePipeline(TINY_PIPE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_generator(0)


def test_step_scales_fold_the_control_window():
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    s = pipe._step_scales(4, [1.0, 2.0, 1.0, 1.0, 1.0, 0.5], [0.0, 0.5, 0, 0, 0, 0],
                          [1.0, 1.0, 0.5, 1, 1, 1])
    assert s.shape == (4, 6)
    np.testing.assert_array_equal(s[:, 1], [0, 0, 2, 2])
    np.testing.assert_array_equal(s[:, 2], [1, 1, 0, 0])
    assert math.isclose(float(s[0, 5]), 0.5)

"""EdgeStylePipeline with the serving knobs against the JAX package's, on
the CPU in fp32 at the TINY configs: the ControlNet cache (an interval and
explicit steps), the UNet cache, ``cfg_interval`` with a window and with
CFG off, guess mode with cache refreshes on CFG-off steps, the ``turbo``
bundle, ToMe, DPM-Solver++ and one LCM step. Each case compiles JAX's
program (5-10 s on one core), so the cases live in a file of their own and
run the two-branch pattern (0, None): one ControlLoRA and the static
ControlNet, the knobs' code paths at two thirds of the six-branch
program's compile time.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import perturb
from tests.test_torch_ops import nchw, nhwc
from tests.test_torch_pipeline import TINY_PIPE
from tests.test_torch_serving import PIPE_ATOL, TURBO, tome_cfgs
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

PATTERN = (0, None)
J_PIPE = dataclasses.replace(J_TINY_PIPE, pattern=PATTERN)
PIPE = dataclasses.replace(TINY_PIPE, pattern=PATTERN)


@pytest.fixture(scope="module")
def pipe_params():
    """The port's TINY two-branch init (seed 0) in the JAX layout, perturbed
    with numpy noise so the zero-init heads are live."""
    tp = EdgeStylePipeline(PIPE, device="cpu").init_params(make_generator(0, "cpu"))
    return perturb(to_jax_params(tp), np.random.default_rng(0))


def _pipe_inputs(seed):
    rng = np.random.default_rng(seed)
    ids, neg = rng.integers(1, 99, size=(2, 1, 7))
    imgs = [(rng.standard_normal((1, 32, 32, 3)) * 0.5).astype(np.float32) for _ in PATTERN]
    return ids, neg, imgs, rng.standard_normal((1, 16, 16, 4)).astype(np.float32)

PIPE_CASES = {  # steps, scheduler, ToMe ratio, call kwargs
    "cn_cache_interval_2": (4, "unipc", 0.0, dict(controlnet_cache_interval=2)),
    "cn_cache_steps": (4, "unipc", 0.0, dict(controlnet_cache_steps=(0, 1, 3))),
    "unet_cache_interval_2": (4, "unipc", 0.0, dict(unet_cache_interval=2)),
    "cfg_interval_0_0.4": (4, "unipc", 0.0, dict(cfg_interval=(0.0, 0.4))),
    "cfg_interval_0_0": (4, "unipc", 0.0, dict(cfg_interval=(0.0, 0.0))),
    # refreshes on CFG-off steps 0 and 1, read by CFG-on steps 2 and 3
    "guess_mode_cn_refresh_cfg_off": (4, "unipc", 0.0, dict(
        guess_mode=True, cfg_interval=(0.5, 1.0), controlnet_cache_steps=(0, 1))),
    "turbo": (4, "unipc", 0.5, TURBO),
    "tome_0.5": (3, "unipc", 0.5, {}),
    "dpm++": (4, "dpm++", 0.0, {}),
    "lcm_1_step": (1, "lcm", 0.0, dict(cfg_interval=(0.0, 0.0))),
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_knobs_match_jax(case, pipe_params):
    """EdgeStylePipeline.__call__ with each knob combination against JAX's on
    the same params, ids, control images and latents: [0, 1] images within
    1e-3; each knob moves the image off the exact one."""
    steps, scheduler, ratio, kw = PIPE_CASES[case]
    jt, tt = tome_cfgs(ratio) if ratio else (None, None)
    ids, neg, imgs, lat = _pipe_inputs(1)
    jpipe = JPipeline(dataclasses.replace(J_PIPE, scheduler=scheduler), attn_impl="xla",
                      tome=jt)
    ref = jpipe(pipe_params, jnp.asarray(ids, jnp.int32), jnp.asarray(neg, jnp.int32),
                [jnp.asarray(im) for im in imgs], latents=jnp.asarray(lat),
                num_inference_steps=steps, **kw)
    pipe = EdgeStylePipeline(dataclasses.replace(PIPE, scheduler=scheduler), device="cpu",
                             tome=tt)
    p = from_jax_params(pipe_params, device="cpu")
    args = (p, torch.from_numpy(ids), torch.from_numpy(neg), [nchw(im) for im in imgs])
    out = pipe(*args, latents=nchw(lat), num_inference_steps=steps, **kw)
    assert out.shape == (1, 3, 32, 32) and torch.isfinite(out).all()
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=PIPE_ATOL)
    if scheduler == "unipc":
        exact = EdgeStylePipeline(PIPE, device="cpu")(
            *args, latents=nchw(lat), num_inference_steps=steps,
            guess_mode=kw.get("guess_mode", False))
        assert (out - exact).abs().max() > 1e-3

"""The port's validation by generation and its image metrics against the
JAX package, on the CPU in fp32.

No JAX pipeline is compiled: both packages' ``log_validation`` are driven by
the same deterministic stub pipeline, and one port-only run goes through the
real TINY port pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.training import validation as jvalidation
from edgestyle_tpu.utils import metrics as jmetrics
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.porting import to_jax_params
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.training import validation
from edgestyle_tpu_torch.training.train_step import init_trainable
from edgestyle_tpu_torch.utils import metrics
from tests.test_torch_pipeline import TINY_PIPE
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

IMAGE_KEYS = ("original", "agnostic", "head", "original_openpose", "clothes", "clothes_openpose",
              "clothes2", "clothes_openpose2")


@pytest.fixture(scope="module")
def tiny():
    """The TINY port pipeline, its frozen weights and a trainable set whose
    every leaf (LoRA ups and heads too) is perturbed away from its init."""
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    gen = make_generator(0, "cpu")
    params = pipe.init_params(gen)
    frozen = {"vae": params["vae"], "clip": params["clip"], "unet": params["unet"],
              "static": params["controlnet"]["static"]}
    trainable = init_trainable(pipe, gen, params["unet"], 4)
    g = torch.Generator().manual_seed(1)
    for leaf in flatten(trainable).values():
        leaf.add_(0.05 * torch.randn(leaf.shape, generator=g))
    return pipe, frozen, trainable


def test_assemble_inference_params_matches_jax(tiny):
    """Both packages' assembly of the same frozen and trainable trees: the
    same keys, each merged trunk leaf within 1e-6."""
    _, frozen, trainable = tiny
    want = jvalidation.assemble_inference_params(to_jax_params(frozen), to_jax_params(trainable))
    got = to_jax_params(validation.assemble_inference_params(frozen, trainable))
    want = {k: np.asarray(v) for k, v in flatten(jax.tree.map(np.asarray, want)).items()}
    got = flatten(got)
    assert got.keys() == want.keys() and len(got) > 100
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=str(k))


def make_batch(b=2, size=16, ids_len=7, seed=0):
    """One collated micro-batch (NHWC numpy, as the JAX package takes it):
    VAE images in [-1, 1] with some out of range, poses in [0, 1]."""
    g = np.random.default_rng(seed)
    batch = {k: (g.random((b, size, size, 3), dtype=np.float32) * 2.4 - 1.2)
             if "openpose" not in k else g.random((b, size, size, 3), dtype=np.float32)
             for k in IMAGE_KEYS}
    batch["input_ids"] = g.integers(1, 90, (b, ids_len)).astype(np.int32)
    return batch


class _Writer:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step, dataformats):
        self.images.append((tag, img, step, dataformats))


def _stub_out(cond, g):
    """The stub generation from branch 2 and branch 1: exact binary scalings."""
    return (cond[2] + 1) * 0.5 * (g / 8) + cond[1] * 0.25


@pytest.mark.parametrize("use_agnostic", [False, True])
def test_log_validation_grid_matches_jax(use_agnostic):
    """Both packages' log_validation on one batch through the same stub
    pipeline: equal grids and logged images; the stub sees each guidance
    scale once, the step count, all-zero negative ids and, in the port, a
    generator seeded alike for every scale."""
    batch = make_batch()
    calls, jcalls = [], []

    def pipe(params, ids, neg, cond, generator, num_inference_steps, guidance_scale):
        assert set(params["controlnet"]) == {"static", "lora_0", "lora_1", "fusion"}
        calls.append((guidance_scale, num_inference_steps, generator.initial_seed()))
        assert not neg.any() and neg.shape == ids.shape
        return _stub_out(cond, guidance_scale)

    def jpipe(params, ids, neg, cond, rng, num_inference_steps, guidance_scale):
        jcalls.append((guidance_scale, num_inference_steps))
        assert not np.asarray(neg).any()
        return _stub_out(cond, guidance_scale)

    pipe.device = torch.device("cpu")
    trees = ({"vae": {}, "clip": {}, "unet": {}, "static": {}},
             {"lora_0": {}, "lora_1": {}, "heads_0": {}, "heads_1": {}, "fusion": {}})
    tbatch = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) if v.ndim == 4
              else torch.from_numpy(v).long() for k, v in batch.items()}
    w, jw = _Writer(), _Writer()
    grid = validation.log_validation(pipe, *trees, tbatch, 5, w, num_inference_steps=8, seed=3,
                                     use_agnostic=use_agnostic)
    want = jvalidation.log_validation(jpipe, *trees, batch, 5, jw, num_inference_steps=8,
                                      use_agnostic=use_agnostic)
    assert grid.shape == want.shape == (7 * 16, 2 * 16, 3)
    np.testing.assert_array_equal(grid, want)
    np.testing.assert_array_equal(w.images[0][1], jw.images[0][1])
    assert [i[::2] for i in w.images] == [("validation", 5)] and w.images[0][3] == "HWC"
    assert [c[:2] for c in calls] == jcalls == [(g, 8) for g in (3.0, 4.5, 6.0, 7.5)]
    assert {c[2] for c in calls} == {3}


@torch.no_grad()
def test_log_validation_through_the_tiny_pipeline(tiny):
    """The real TINY port pipeline, 2 steps at two guidance scales: a finite
    grid in [0, 1] of the expected shape, and the same grid again from the
    same seed."""
    pipe, frozen, trainable = tiny
    batch = make_batch(size=32)
    tbatch = {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()) if v.ndim == 4
              else torch.from_numpy(v).long() for k, v in batch.items()}
    run = lambda: validation.log_validation(  # noqa: E731
        pipe, frozen, trainable, tbatch, 1, guidance_scales=(3.0, 7.5), num_inference_steps=2)
    grid = run()
    assert grid.shape == (5 * 32, 2 * 32, 3) and grid.dtype == np.float32
    assert np.isfinite(grid).all() and grid.min() >= 0.0 and grid.max() <= 1.0
    assert not np.array_equal(grid[96:128], grid[128:160])  # the two scales differ
    np.testing.assert_array_equal(run(), grid)


@pytest.mark.parametrize("name", ["ssim", "psnr", "mae", "clip_score"])
def test_metrics_match_jax(name):
    """Each metric at (2, 32, 32, 3) within 1e-5 (relative for PSNR's dB)."""
    g = np.random.default_rng(7)
    a = g.random((2, 32, 32, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * g.standard_normal(a.shape).astype(np.float32), 0, 1)
    if name == "clip_score":
        proj = g.standard_normal((32 * 32 * 3, 8)).astype(np.float32) / 55.0
        txt = g.standard_normal((2, 8)).astype(np.float32)
        got = metrics.clip_score(lambda x: x.reshape(2, -1) @ torch.from_numpy(proj),
                                 torch.from_numpy(a), torch.from_numpy(txt))
        want = jmetrics.clip_score(lambda x: x.reshape(2, -1) @ jnp.asarray(proj),
                                   jnp.asarray(a), jnp.asarray(txt))
    else:
        got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b))
        want = getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(want)
    assert got.shape == want.shape == (2,)
    scale = np.abs(want).max() if name == "psnr" else 1.0
    assert np.abs(got.numpy() - want).max() / scale < 1e-5
    if name == "ssim":
        assert np.allclose(metrics.ssim(torch.from_numpy(a), torch.from_numpy(a)).numpy(), 1.0)

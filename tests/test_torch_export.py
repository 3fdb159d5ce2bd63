"""The deployment export (core/export.py, apps/export.py,
pipelines/artifact.py) against the JAX package's, on the CPU in fp32 at the
TINY configs, and the card route traced on the CPU.

One module fixture exports ``--what all`` in both packages from the same
params (the port's TINY init moved to JAX with ``to_jax_params`` and
perturbed, so the zero-init heads are live) and loads both artifact
directories once: each reloaded ``.pt2`` is held to JAX's reloaded
``.stablehlo`` on the same inputs, and the port's host loop to JAX's; the
CLI parses as JAX's. The generate program and the card route traced on the
CPU are in tests/test_torch_export_program.py (a file of its own, so that
the two run on two workers). JAX's programs stay out of the persistent
compilation cache (``no_persistent_compile_cache``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.apps import export as japp
from edgestyle_tpu.core import export as jexport
from edgestyle_tpu.pipelines.artifact import ArtifactPipeline as JArtifactPipeline
from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu_torch.apps import export
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.export import flop_report, load_program
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.pipelines.artifact import ArtifactPipeline, stage_params
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import perturb
from tests.test_torch_ops import nchw, nhwc
from tests.test_torch_pipeline import TINY_PIPE
from tests.test_torch_segmenter import no_persistent_compile_cache  # noqa: F401 (autouse)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-4  # fp32 on both sides (tests/test_torch_models.py)
GRAPH_ATOL = {"unet_controlnet": 3e-4}  # the CFG combine scales the step's difference by 3.5
ALL_ARGV = ["--random_init", "--what", "all", "--dtype", "float32"]


def _params(cfg, seed):
    """The port's TINY init of ``cfg`` in the JAX layout, perturbed."""
    tp = EdgeStylePipeline(cfg, device="cpu").init_params(make_generator(0, "cpu"))
    return perturb(to_jax_params(tp), np.random.default_rng(seed))


def _export_both(tmp, argv, cfg, jcfg, jparams, stub_jax_export=False):
    """Both packages' export CLI on ``argv`` with ``jparams`` in place of
    their random init; JAX's flop report (another XLA compile, not compared)
    is stubbed, and with ``stub_jax_export`` its export too (for
    serving.json alone). Returns the two output directories."""
    ours, theirs = tmp / "port", tmp / "jax"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(EdgeStylePipeline, "init_params",
                   lambda self, gen: from_jax_params(jparams, device="cpu"))
        mp.setattr(JPipeline, "init_params",
                   lambda self, key: jax.tree.map(jnp.asarray, jparams))
        mp.setattr(jexport, "flop_report", lambda fn, *a: {"flops": 0.0})
        if stub_jax_export:
            mp.setattr(jexport, "export_program", lambda fn, ex, path, **kw: path)
        export.main(argv + ["--output_dir", str(ours)], config=cfg, device="cpu")
        japp.main(argv + ["--output_dir", str(theirs)], config=jcfg)
    return ours, theirs


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jparams = _params(TINY_PIPE, 1)
    ours, theirs = _export_both(tmp_path_factory.mktemp("all"), ALL_ARGV, TINY_PIPE,
                                J_TINY_PIPE, jparams)
    return {"jparams": jparams, "params": from_jax_params(jparams, device="cpu"),
            "art": ArtifactPipeline(str(ours), device="cpu"), "jart": JArtifactPipeline(str(theirs)),
            "enc": load_program(str(ours / "vae_encoder.pt2")),
            "jenc": jexport.load_program(str(theirs / "vae_encoder.stablehlo")), "dir": ours}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ids, neg = rng.integers(1, 99, size=(2, 1, 7))
    imgs = [(rng.standard_normal((1, 32, 32, 3)) * 0.5).astype(np.float32) for _ in range(6)]
    return ids, neg, imgs, rng


def _to_nhwc(x):
    return [_to_nhwc(v) for v in x] if isinstance(x, (list, tuple)) else (
        nhwc(x) if x.ndim == 4 else x.numpy())


@pytest.mark.parametrize("name", ["text_encoder", "cond_embed", "unet_controlnet",
                                  "vae_encoder", "vae_decoder"])
def test_per_stage_graphs_match_jax(exported, name):
    """Each reloaded .pt2 against JAX's reloaded .stablehlo on the same
    params and inputs (NHWC there, NCHW here): within 1e-4, the denoise step
    3e-4 (fp32 both sides; the CFG combine multiplies the step's difference
    by the guidance scale)."""
    ids, neg, imgs, rng = _inputs(2)
    jp, p = exported["jparams"], stage_params(name, exported["params"])
    t_ids, t_neg = torch.from_numpy(ids), torch.from_numpy(neg)
    t_imgs = [nchw(im) for im in imgs]
    if name == "text_encoder":
        ours = exported["art"].graphs[name].call(p, t_ids, t_neg)
        theirs = exported["jart"].graphs[name].call(jp, jnp.asarray(ids, jnp.int32),
                                                    jnp.asarray(neg, jnp.int32))
    elif name == "cond_embed":
        ours = exported["art"].graphs[name].call(p, t_imgs)
        theirs = exported["jart"].graphs[name].call(jp, [jnp.asarray(im) for im in imgs])
    elif name == "unet_controlnet":
        sample = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
        ctx = (rng.standard_normal((2, 7, 24)) * 0.5).astype(np.float32)
        embs = [(rng.standard_normal((2, 16, 16, 32)) * 0.1).astype(np.float32)
                for _ in range(6)]
        ours = exported["art"].graphs[name].call(
            p, nchw(sample), torch.tensor(500), torch.from_numpy(ctx), [nchw(e) for e in embs],
            torch.tensor(3.5))
        theirs = exported["jart"].graphs[name].call(
            jp, jnp.asarray(sample), jnp.asarray(500, jnp.int32), jnp.asarray(ctx),
            [jnp.asarray(e) for e in embs], jnp.asarray(3.5, jnp.float32))
    elif name == "vae_encoder":
        key = jax.random.key(4)
        noise = np.asarray(jax.random.normal(key, (1, 16, 16, 4), jnp.float32))
        ours = exported["enc"].call(p, t_imgs[0], nchw(noise))
        theirs = exported["jenc"].call(jp, jnp.asarray(imgs[0]), key)
    else:
        lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
        ours = exported["art"].graphs[name].call(p, nchw(lat))
        theirs = exported["jart"].graphs[name].call(jp, jnp.asarray(lat))
    ours, theirs = _to_nhwc(ours), jax.tree.map(np.asarray, theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, b, atol=GRAPH_ATOL.get(name, ATOL), rtol=0)


def test_reloaded_program_checks_its_inputs(exported):
    """A reloaded graph refuses arguments of another structure, shape or
    type, as torch's own input check would."""
    prog = exported["art"].graphs["vae_decoder"]
    p = stage_params("vae_decoder", exported["params"])
    with pytest.raises(ValueError, match="shaped as"):
        prog.call(p, torch.zeros(1, 4, 16, 16), torch.zeros(1))
    with pytest.raises(ValueError, match="got .1, 4, 8, 8."):
        prog.call(p, torch.zeros(1, 4, 8, 8))
    with pytest.raises(ValueError, match="torch.float64"):
        prog.call(p, torch.zeros(1, 4, 16, 16, dtype=torch.float64))
    assert prog.call(p, torch.zeros(1, 4, 16, 16)).shape == (1, 3, 32, 32)


def test_host_loop_matches_jax(exported):
    """The port's ArtifactPipeline host loop (UniPC, 2 steps) against JAX's
    on the latents ``jax.random.normal`` gives JAX's: [0, 1] images within
    1e-3. Exact-valued knobs pass both; a cache interval or CFG window is
    refused by both with the same ValueError."""
    ids, neg, imgs, _ = _inputs(3)
    key = jax.random.key(5)
    art, jart = exported["art"], exported["jart"]
    lat = np.asarray(jax.random.normal(key, jart.latent_shape, jnp.float32))
    assert art.latent_shape == (1, 4, 16, 16) and jart.latent_shape == (1, 16, 16, 4)
    exact = dict(controlnet_cache_interval=1, cfg_interval=(0.0, 1.0), unet_cache_steps=None)
    theirs = jart(exported["jparams"], jnp.asarray(ids, jnp.int32), jnp.asarray(neg, jnp.int32),
                  [jnp.asarray(im) for im in imgs], rng=key, num_inference_steps=2, **exact)
    ours = art(exported["params"], torch.from_numpy(ids), torch.from_numpy(neg),
               [nchw(im) for im in imgs], latents=nchw(lat), num_inference_steps=2, **exact)
    assert float(ours.min()) >= 0 and float(ours.max()) <= 1
    np.testing.assert_allclose(nhwc(ours), np.asarray(theirs), atol=1e-3, rtol=0)
    for knobs in (dict(controlnet_cache_interval=2), dict(cfg_interval=(0.0, 0.5)),
                  dict(unet_cache_steps=(0, 1))):
        with pytest.raises(ValueError, match="what generate") as jerr:
            jart(exported["jparams"], ids, neg, imgs, num_inference_steps=2, **knobs)
        with pytest.raises(ValueError, match="what generate") as err:
            art(exported["params"], ids, neg, imgs, num_inference_steps=2, **knobs)
        assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("argv", [
    [], ["--mode", "aggressive", "--steps", "4"], ["--what", "generate", "--mode", "lcm"],
    ["--quant", "int8-static", "--tome", "0.3", "--dtype", "float32", "--batch", "2"],
    ["--mode", "turbo", "--cfg_interval", "0", "1", "--scheduler", "dpm++", "--what", "vae"],
])
def test_cli_parses_like_jax(argv):
    """The export CLI's dests and values, defaults and serving-mode folding
    included, are JAX's."""
    argv = ["--output_dir", "out"] + argv
    norm = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in vars(d).items()}  # noqa
    assert norm(export.parse_args(argv)) == norm(japp.parse_args(argv))


def test_flop_report_counts_the_plain_route(exported):
    """flop_report of the reloaded TINY denoise graph on the CPU: the matmul
    and conv FLOPs that FlopCounterMode counts, on fake tensors."""
    ids, _, _, rng = _inputs(9)
    prog = exported["art"].graphs["unet_controlnet"]
    args = (exported["params"], torch.zeros(1, 4, 16, 16), torch.tensor(9),
            torch.zeros(2, 7, 24), [torch.zeros(2, 32, 16, 16) for _ in range(6)],
            torch.tensor(3.5))
    rep = flop_report(prog.call, stage_params("unet_controlnet", args[0]), *args[1:])
    assert rep["flops"] > 1e8 and rep["flops"] == sum(rep["by_operator"].values())
    assert {"aten.convolution", "aten.mm"} <= set(rep["by_operator"])

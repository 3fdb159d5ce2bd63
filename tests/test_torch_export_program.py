"""The deployment export's whole-generation program and the card route
traced on the CPU (tests/test_torch_export.py holds the per-stage graphs).

The generate program runs the two-branch pattern (one ControlLoRA, the
static ControlNet) at 2 steps with a baked ControlNet refresh schedule and
CFG window: its ``serving.json`` is JAX's, its image the live pipeline's,
and its knob checks refuse what JAX's refuse. The TINY denoise step (a
64 px VAE, so level 0 has 1,024 tokens and reaches the flash kernel) is
traced by ``torch.export`` on fake CUDA inputs: the graph holds the port's
kernel operators at the counts the code predicts, with the plain versions'
shapes, types and strides, and no card is needed.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from edgestyle_tpu.pipelines.artifact import ArtifactPipeline as JArtifactPipeline
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.export import _Program
from edgestyle_tpu_torch.core.porting import from_jax_params
from edgestyle_tpu_torch.ops import flash, fused_conv
from edgestyle_tpu_torch.pipelines.artifact import ArtifactPipeline
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_export import _export_both, _inputs, _params
from tests.test_torch_ops import nchw
from tests.test_torch_pipeline import TINY_PIPE
from tests.test_torch_segmenter import no_persistent_compile_cache  # noqa: F401 (autouse)
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

PATTERN = (0, None)
GEN_ARGV = ["--random_init", "--what", "generate", "--dtype", "float32", "--steps", "2",
            "--cfg_interval", "0", "0.5", "--controlnet_cache_steps", "0"]


def test_generate_program_bakes_the_knobs_like_jax(tmp_path):
    """--what generate with a baked CFG window and ControlNet refresh
    schedule, two-branch pattern, 2 steps: serving.json is JAX's, key for
    key and value for value; the reloaded program gives the live pipeline's
    image under the same knobs (fp32, within 1e-5) from the same generator;
    and ``_check_baked`` accepts and refuses the same requests as JAX's,
    with the same messages."""
    cfg = dataclasses.replace(TINY_PIPE, pattern=PATTERN)
    jcfg = dataclasses.replace(J_TINY_PIPE, pattern=PATTERN)
    jparams = _params(cfg, 6)
    ours, theirs = _export_both(tmp_path, GEN_ARGV, cfg, jcfg, jparams, stub_jax_export=True)
    serving = json.loads((ours / "serving.json").read_text())
    assert serving == json.loads((theirs / "serving.json").read_text())
    assert serving["controlnet_cache_steps"] == [0] and serving["num_inference_steps"] == 2
    assert not (ours / "unet_controlnet.pt2").exists()

    art = ArtifactPipeline(str(ours), device="cpu")
    assert art.one_program and art.renoise_count == 0 and art.image_shape == (1, 3, 32, 32)
    pipe = EdgeStylePipeline(cfg, device="cpu")
    params = from_jax_params(jparams, device="cpu")
    ids, neg, imgs, _ = _inputs(7)
    imgs = [nchw(im) for im in imgs[:len(PATTERN)]]
    knobs = dict(cfg_interval=(0.0, 0.5), controlnet_cache_steps=(0,))
    live = pipe(params, ids, neg, imgs, generator=make_generator(8, "cpu"),
                num_inference_steps=2, **knobs)
    got = art(params, ids, neg, imgs, generator=make_generator(8, "cpu"),
              num_inference_steps=2, **knobs)
    torch.testing.assert_close(got, live, atol=1e-5, rtol=0)

    jart = JArtifactPipeline.__new__(JArtifactPipeline)
    jart.serving = json.loads((theirs / "serving.json").read_text())
    requests = [(2, knobs), (2, dict(knobs, controlnet_cache_steps=[0])),
                (3, knobs), (2, {}), (2, dict(knobs, cfg_interval=(0.0, 1.0))),
                (2, dict(knobs, controlnet_cache_steps=(0, 1))),
                (2, dict(knobs, unet_cache_interval=2))]
    for steps, kw in requests:
        outcome = []
        for a in (jart, art):
            try:
                a._check_baked(steps, kw)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], (steps, kw)
    assert outcome[0] is not None


# ------------------------------------------------- the card route, traced on the CPU
def _basic_index(t, idx):
    """Tensor.__getitem__ for ints, slices, None and Ellipsis, through
    ATen's view operators."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(isinstance(i, (torch.Tensor, list, bool)) for i in idx):
        raise NotImplementedError(f"advanced index {idx!r}")
    if Ellipsis in idx:
        k = idx.index(Ellipsis)
        real = sum(i is not None and i is not Ellipsis for i in idx)
        idx = idx[:k] + (slice(None),) * (t.dim() - real) + idx[k + 1:]
    dim = 0
    for i in idx:
        if i is None:
            t, dim = t.unsqueeze(dim), dim + 1
        elif isinstance(i, int):
            t = t.select(dim, i)
        else:
            start, stop, step = i.indices(t.shape[dim])
            if (start, stop, step) != (0, t.shape[dim], 1):
                t = torch.ops.aten.slice.Tensor(t, dim, start, stop, step)
            dim += 1
    return t


class FakeCudaIndexing(torch.overrides.TorchFunctionMode):
    """Basic indexing of fake CUDA tensors on a CPU-only torch build.
    ``Tensor.__getitem__`` takes a device guard in C++ before it dispatches,
    and a CPU-only build has none for CUDA; every other operator reaches the
    fake tensors through the dispatcher. A card's torch needs none of this."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            return _basic_index(*args)
        return func(*args, **(kwargs or {}))


def _plain_meta(target, args):
    """(shape, dtype, stride) of each output of the op's plain version on
    CPU zeros shaped, typed and strided as the node's inputs."""
    def real(a):
        if not isinstance(a, torch.Tensor):
            return a
        return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype).zero_()

    args = [real(a) for a in args]
    name = str(target)
    if "flash_fwd" in name:
        q, k, v, scale = args
        out = (flash.flash_attention_reference(q, k, v, scale),
               flash.flash_attention_reference_lse(q, k, scale))
    elif "gn_scale_shift" in name:
        out = fused_conv.gn_scale_shift_reference(*args)
    elif "flash_bwd_dq" in name:
        out = (flash.flash_bwd_dq_reference(*args),)
    elif "flash_bwd_dkv" in name:
        out = flash.flash_bwd_dkv_reference(*args)
    else:
        out = (fused_conv.fused_gn_silu_conv3x3_reference(*args),)
    return [(tuple(o.shape), o.dtype, o.stride()) for o in out]


def _fake_meta(val):
    vals = val if isinstance(val, (tuple, list)) else (val,)
    return [(tuple(v.shape), v.dtype, v.stride()) for v in vals]


def test_fake_cuda_trace_holds_the_kernel_operators():
    """torch.export of the TINY bf16 denoise step (mcn + UNet + CFG, the
    six-branch pattern, 32 x 32 latents) on fake CUDA tensors: the card's
    route traced on the CPU. The graph holds one flash_fwd node per
    self-attention of >= 1024 tokens (level 0's: each trunk's down block,
    the UNet's down and up blocks) and one gn_scale_shift and one
    fused_gn_silu_conv3x3 per ResNet conv (each trunk's down and mid
    blocks, the UNet's down, mid and up blocks), and no plain group_norm
    of theirs; each node's fake outputs have the plain version's shape,
    type and stride (the conv's channels_last). The backward operators'
    fakes, called alone, do too; the FLOP formulas count 4, 6 and 8 N^2 D a
    head and 2 B H W Cin Cout 9."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(TINY_PIPE, dtype="bfloat16",
                              vae=dataclasses.replace(TINY_PIPE.vae, sample_size=64))
    pipe = EdgeStylePipeline(cfg, device="cpu")
    params = pipe.init_params(make_generator(0, "cpu"))
    n_br, hw = cfg.num_branches, 32
    ones = np.ones((n_br,), np.float32)

    def step(p, sample, t, context, embs, guidance):
        return pipe._eval_step(True, p, context, None, embs, ones, guidance, 1, False, sample, t)

    def fake_cuda(shape, dtype=torch.float32, channels_last=False):
        """A fake CUDA tensor (channels_last strides made by hand: the
        Python ``contiguous`` takes a device guard as ``__getitem__`` does)."""
        t = torch.empty(shape, dtype=dtype)
        if channels_last:
            t = t.contiguous(memory_format=torch.channels_last)
        return torch.empty_strided(shape, t.stride(), dtype=dtype, device="cuda")

    with FakeTensorMode(), FakeCudaIndexing():
        fake = pytree.tree_map_only(torch.Tensor, lambda a: torch.empty_strided(
            a.shape, a.stride(), dtype=a.dtype, device="cuda"), params)
        args = (fake, fake_cuda((1, 4, hw, hw), channels_last=True),
                torch.tensor(500, device="cuda"), fake_cuda((2, 7, 24), torch.bfloat16),
                [fake_cuda((2, 32, hw, hw), channels_last=True) for _ in range(n_br)],
                torch.tensor(3.5, device="cuda"))
        with torch.no_grad():
            ep = torch.export.export(_Program(step), args, strict=False)

    levels, layers = len(cfg.unet.block_out_channels), cfg.unet.layers_per_block
    trunk_resnets = levels * layers + 2
    unet_resnets = trunk_resnets + levels * (layers + 1)
    trunk_calls = len(set(cfg.pattern))
    want = {"flash_fwd": trunk_calls * layers + layers + (layers + 1),
            "gn_scale_shift": trunk_calls * trunk_resnets * 2 + unet_resnets * 2}
    want["fused_gn_silu_conv3x3"] = want["gn_scale_shift"]
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("edgestyle.")]
    got = {k: sum(str(n.target) == f"edgestyle.{k}.default" for n in nodes) for k in want}
    assert got == want == {"flash_fwd": 6, "gn_scale_shift": 40, "fused_gn_silu_conv3x3": 40}
    for n in nodes:
        ins = [a.meta["val"] if isinstance(a, torch.fx.Node) else a for a in n.args]
        assert _fake_meta(n.meta["val"]) == _plain_meta(n.target, ins), n.name

    bf16 = torch.bfloat16
    with FakeTensorMode(), FlopCounterMode(display=False) as counter:
        q, lse = fake_cuda((1, 2, 64, 8), bf16), fake_cuda((1, 2, 64))
        x, s = fake_cuda((2, 16, 8, 8), bf16, True), fake_cuda((2, 16))
        w = fake_cuda((24, 16, 3, 3), bf16, True)
        calls = {"flash_fwd": (q, q, q, 0.3), "flash_bwd_dq": (q, q, q, q, lse, lse, 0.3),
                 "flash_bwd_dkv": (q, q, q, q, lse, lse, 0.3),
                 "fused_gn_silu_conv3x3": (x, s, s, w, fake_cuda((24,), bf16))}
        metas = {k: _fake_meta(getattr(torch.ops.edgestyle, k)(*a)) for k, a in calls.items()}
    for k, a in calls.items():
        assert metas[k] == _plain_meta(k, a), k
    per_head = 2 * 64 * 64 * 8
    assert {str(k): v for k, v in counter.get_flop_counts()["Global"].items()} == {
        "edgestyle.flash_fwd": 4 * per_head, "edgestyle.flash_bwd_dq": 6 * per_head,
        "edgestyle.flash_bwd_dkv": 8 * per_head,
        "edgestyle.fused_gn_silu_conv3x3": 2 * 2 * 8 * 8 * 16 * 24 * 9}


def test_static_int8_scales_made_in_a_trace_stay_out_of_the_cache():
    """ops/quant.py keeps each static scale it makes on a device for the
    next call; one made while torch.export traces is the tracer's fake
    tensor and must not be kept (an int8-static export's live parity run
    computed on it)."""
    from edgestyle_tpu_torch.ops import quant

    table = {"layer": 0.5}
    x = torch.randn(4, 8)

    def fn(x):
        with quant.quantize_intercept(True, static_scales=table):
            q, s = quant.activation_to_int8(x, "layer")
        return q.float() * s

    torch.export.export(_Program(fn), (x,), strict=False)
    with quant.quantize_intercept(True, static_scales=table):
        q, s = quant.activation_to_int8(x, "layer")
    assert type(s) is torch.Tensor and float(s) == 0.5
    torch.testing.assert_close(q.float(), torch.clamp(torch.round(x / 0.5), -127, 127))


def test_lcm_renoise_drawn_by_the_caller_equals_the_generators():
    """An LCM generation given its re-noise (``lcm_noise``: what a generate
    program takes as an input, drawn after the latents from the caller's
    generator) equals the one that draws it from the generator: the same
    image, and the plan refuses a count that is not steps - 1."""
    cfg = dataclasses.replace(TINY_PIPE, pattern=PATTERN, scheduler="lcm")
    pipe = EdgeStylePipeline(cfg, device="cpu")
    params = from_jax_params(_params(cfg, 10), device="cpu")
    ids, neg, imgs, _ = _inputs(11)
    imgs = [nchw(im) for im in imgs[:len(PATTERN)]]
    kw = dict(num_inference_steps=3, cfg_interval=(0.0, 0.0))
    live = pipe(params, ids, neg, imgs, generator=make_generator(12, "cpu"), **kw)
    gen = make_generator(12, "cpu")
    lat, *noise = (torch.randn((1, 4, 16, 16), generator=gen) for _ in range(3))
    given = pipe(params, ids, neg, imgs, latents=lat, lcm_noise=noise, **kw)
    assert torch.equal(given, live)
    with pytest.raises(ValueError, match="re-noise 2 times"):
        pipe(params, ids, neg, imgs, latents=lat, lcm_noise=noise[:1], **kw)

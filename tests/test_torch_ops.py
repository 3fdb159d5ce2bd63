"""Parity of the PyTorch port's ops (edgestyle_tpu_torch.ops) with the JAX
package's, on the CPU in fp32, and of its CUDA kernels with their plain
versions on the card (skipped without one).

The same numpy inputs, made from a seed, go through both sides. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU.
"""

import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import edgestyle_tpu.ops.flash as jflash
from edgestyle_tpu.ops import fused_conv as jfc
from edgestyle_tpu.ops.attention import multi_head_attention as j_mha
from edgestyle_tpu.ops.norms import group_norm as j_group_norm
from edgestyle_tpu.ops.norms import layer_norm as j_layer_norm
from edgestyle_tpu_torch.ops import flash, fused_conv
from edgestyle_tpu_torch.ops.attention import multi_head_attention, pick_impl
from edgestyle_tpu_torch.ops.norms import group_norm, layer_norm
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-4  # fp32 on both sides; differences are summation order only


def nchw(x):
    return torch.from_numpy(np.array(x, dtype=np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
    yield


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax(rng, act):
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    ref = j_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5,
                       act=jax.nn.silu if act else None)
    out = group_norm(nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5,
                     act=F.silu if act else None)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL)


def test_group_norm_bf16_single_pass_matches_jax(rng):
    """bf16 input: both sides take single-pass fp32 moments; outputs agree
    to one bf16 rounding (8 mantissa bits on |y| < 8: 3e-2)."""
    x = (rng.standard_normal((2, 4, 4, 64)) * 2 + 5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ones, zeros = np.ones(64, np.float32), np.zeros(64, np.float32)
    ref = np.asarray(j_group_norm(xb, jnp.asarray(ones), jnp.asarray(zeros), 32)).astype(
        np.float32)
    xt = nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = group_norm(xt, torch.from_numpy(ones), torch.from_numpy(zeros), 32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(out), ref, atol=3e-2)


def test_layer_norm_matches_jax(rng):
    x = rng.standard_normal((2, 7, 24)).astype(np.float32) * 2
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    ref = j_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("d", [40, 80])
def test_flash_reference_matches_jax_pallas(rng, pallas_interpret, d):
    """The port's plain flash version against the JAX Pallas forward kernel
    (interpret mode) at N=1024, the dispatch threshold; output and lse."""
    b, h, n = 1, 2, 1024
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    ref, ref_lse = jflash._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         scale, block_q=512, block_k=512, return_lse=True)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out = flash.flash_attention(qt, kt, vt, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    lse = flash.flash_attention_reference_lse(qt, kt, scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=ATOL)


@pytest.mark.parametrize("d", [40, 80])
def test_flash_backward_reference_matches_jax_pallas(rng, pallas_interpret, d):
    """The port's plain flash backward against the JAX Pallas backward
    kernels (interpret mode), fed the same forward output and lse, at two
    blocks per axis so the accumulation over blocks is exercised."""
    b, h, n = 1, 2, 256
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jflash._flash_forward(jq, jk, jv, scale, block_q=128, block_k=128,
                                     return_lse=True)
    ref = jflash._flash_backward(jq, jk, jv, out, lse, jnp.asarray(g), scale, block_q=128,
                                 block_k=128)
    got = flash.flash_attention_backward_reference(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, g)), scale)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("route", ["flash_attention", "FlashAttention"])
def test_flash_attention_autograd_matches_jax_vjp(rng, pallas_interpret, route):
    """Gradients of q, k and v through the port's flash_attention and
    through the FlashAttention Function it calls (CPU: the plain forward and
    plain backward the card's kernels follow) against jax.vjp of the JAX
    custom VJP, whose backward is the Pallas kernels."""
    b, h, n, d = 1, 2, 256, 40
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    fwd = functools.partial(jflash._flash_forward, block_q=128, block_k=128)
    bwd = functools.partial(jflash._flash_backward, block_q=128, block_k=128)

    @jax.custom_vjp
    def jattn(q, k, v):
        return fwd(q, k, v, scale)

    def jattn_fwd(q, k, v):
        out, lse = fwd(q, k, v, scale, return_lse=True)
        return out, (q, k, v, out, lse)

    jattn.defvjp(jattn_fwd, lambda res, gr: bwd(*res, gr, scale))
    ref_out, vjp = jax.vjp(jattn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    fn = flash.flash_attention if route == "flash_attention" else flash.FlashAttention.apply
    out = fn(qt, kt, vt, scale)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=ATOL)
    for name, t, r in zip("qkv", (qt, kt, vt), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("route", ["norm_act_conv3x3", "NormActConv3x3"])
def test_norm_act_conv3x3_autograd_matches_jax_vjp(route, monkeypatch):
    """Gradients of all five inputs (x, GN scale and shift, kernel, bias)
    through the port's op and through the NormActConv3x3 Function it calls
    (CPU: its backward recomputes the plain version, as on the card) against
    jax.vjp of JAX's ``_fused`` custom VJP, whose forward is the Pallas
    kernel (interpret mode)."""
    monkeypatch.setattr(jfc, "_FORCE_INTERPRET", True)
    b, h, w, cin, cout, groups = 2, 6, 5, 32, 16, 8
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    gamma = rng.standard_normal(cin).astype(np.float32)
    beta = rng.standard_normal(cin).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda *a: jfc._fused(*a, groups, 1e-5, jnp.float32),
                           *(jnp.asarray(a) for a in (x, gamma, beta, k, bias)))
    ref = vjp(jnp.asarray(g))
    xt = nchw(x).requires_grad_(True)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    inputs = [xt, torch.from_numpy(gamma).requires_grad_(True),
              torch.from_numpy(beta).requires_grad_(True), wt.requires_grad_(True),
              torch.from_numpy(bias).requires_grad_(True)]
    if route == "norm_act_conv3x3":
        out = fused_conv.norm_act_conv3x3(*inputs, num_groups=groups, eps=1e-5,
                                          dtype=torch.float32)
    else:
        out = fused_conv.NormActConv3x3.apply(*inputs, groups, 1e-5, torch.float32)
    out.backward(nchw(g))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref_out), atol=ATOL, rtol=1e-4)
    got = [nhwc(xt.grad), inputs[1].grad.numpy(), inputs[2].grad.numpy(),
           inputs[3].grad.permute(2, 3, 1, 0).numpy(), inputs[4].grad.numpy()]
    for name, a, r in zip(("x", "gamma", "beta", "kernel", "bias"), got, ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=1e-3, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("nq,nk,heads", [(64, 7, 2), (16, 16, 1), (1024, 1024, 2)])
def test_multi_head_attention_matches_jax(rng, nq, nk, heads):
    c = 16
    q = rng.standard_normal((2, nq, c)).astype(np.float32)
    k = rng.standard_normal((2, nk, c)).astype(np.float32)
    v = rng.standard_normal((2, nk, c)).astype(np.float32)
    ref = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, impl="xla")
    out = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_attention_dispatch_rule():
    """CPU tensors always take the plain version; the flash kernels are for
    CUDA tensors of any float type with nq == nk >= 1024 and head dim % 8
    == 0, up to 128: an fp32 model's long attentions take the kernels too,
    as the reference's Pallas kernel takes fp32. The rule reads q's device
    alone, so a stand-in with is_cuda set plays the card's tensor here."""
    cpu = torch.zeros(1)
    assert pick_impl(cpu, 4096, 4096, 40) == "plain"
    assert pick_impl(cpu.to(torch.bfloat16), 4096, 4096, 40) == "plain"
    meta = torch.zeros(1, device="meta")
    assert pick_impl(meta, 4096, 4096, 40) == "plain"

    def card(dtype):
        return SimpleNamespace(is_cuda=True, dtype=dtype)

    assert pick_impl(card(torch.bfloat16), 4096, 4096, 40) == "flash"
    assert pick_impl(card(torch.bfloat16), 1024, 1024, 80) == "flash"
    assert pick_impl(card(torch.float32), 4096, 4096, 40) == "flash"
    assert pick_impl(card(torch.float32), 1024, 1024, 80) == "flash"
    assert pick_impl(card(torch.float32), 4096, 77, 40) == "plain"
    assert pick_impl(card(torch.bfloat16), 4096, 77, 40) == "plain"
    assert pick_impl(card(torch.bfloat16), 4096, 4096, 512) == "plain"


@pytest.mark.parametrize("device,x_dtype,w_dtype,kernels", [
    ("cuda", torch.bfloat16, torch.bfloat16, True),
    ("cuda", torch.float32, torch.bfloat16, True),
    ("cuda", torch.float32, torch.float32, False),
    ("cuda", torch.bfloat16, torch.float32, False),
    ("cpu", torch.bfloat16, torch.bfloat16, False),
    ("cpu", torch.float32, torch.float32, False)])
def test_conv_dispatch_rule(device, x_dtype, w_dtype, kernels):
    """The fused conv op takes the kernels for CUDA x (bf16, or fp32 as in
    the LoRA trunks' first convs) with a bf16 weight; an fp32 weight (an
    fp32 model) and every CPU tensor take the plain version. The rule reads
    x's device and the weight's type alone: a stand-in plays the card's x."""
    x = SimpleNamespace(is_cuda=device == "cuda", dtype=x_dtype)
    assert fused_conv.takes_kernels(x, torch.zeros(1, dtype=w_dtype)) is kernels


def test_conv_kernel_route_returns_requested_dtype(monkeypatch):
    """On the kernels' route the op returns its dtype argument, as the plain
    version does, though the conv kernel writes bf16: the route is run here
    with the conv kernel's plain version in the kernel's place."""
    rng = np.random.default_rng(6)
    x, gamma, beta, k, bias = _fused_inputs(rng, 1, 6, 5, 32, 16)
    monkeypatch.setattr(fused_conv, "takes_kernels", lambda x, w: True)
    monkeypatch.setattr(fused_conv, "fused_route", functools.partial(
        fused_conv.fused_route, conv=fused_conv.fused_gn_silu_conv3x3_reference))
    args = (nchw(x).contiguous(memory_format=torch.channels_last), torch.from_numpy(gamma),
            torch.from_numpy(beta), _oihw(k, torch.bfloat16), torch.from_numpy(bias))
    for dtype in (torch.bfloat16, torch.float32):
        out = fused_conv.norm_act_conv3x3(*args, num_groups=8, dtype=dtype)
        assert out.dtype == dtype


@pytest.mark.parametrize(
    "shape", [(2, 8, 6, 32, 16, 4), (1, 6, 6, 64, 64, 8), (3, 5, 7, 32, 48, 4)])
def test_fused_conv_reference_matches_jax_pallas(shape):
    """The port's plain fused conv against the JAX Pallas kernel (interpret
    mode) fed the JAX GN scale/shift; and the port's folded scale/shift
    against JAX's."""
    b, h, w, cin, cout, groups = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    gamma = rng.standard_normal(cin).astype(np.float32)
    beta = rng.standard_normal(cin).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    js, jt = jfc._gn_scale_shift(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                 groups, 1e-5)
    ref = jfc._pallas_forward(jnp.asarray(x), js, jt, jnp.asarray(k), jnp.asarray(bias),
                              interpret=True)
    wt = torch.from_numpy(k).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out = fused_conv.norm_act_conv3x3(nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                                      wt, torch.from_numpy(bias), num_groups=groups, eps=1e-5,
                                      dtype=torch.float32)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL, rtol=1e-4)
    s, t = fused_conv.gn_scale_shift(nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                                     groups, 1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5, rtol=1e-5)


def test_gn_scale_shift_bf16_matches_jax(rng):
    """The fused conv's folded scale/shift from a bf16 image: both sides take
    single-pass fp32 moments of the same bf16 values, so they agree to fp32
    rounding of the sums (the mean of 5 +- 2 values: 1e-4 relative)."""
    x = (rng.standard_normal((2, 6, 5, 64)) * 2 + 5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    gamma = rng.standard_normal(64).astype(np.float32)
    beta = rng.standard_normal(64).astype(np.float32)
    js, jt = jfc._gn_scale_shift(xb, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-5)
    xt = nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    s, t = fused_conv.gn_scale_shift(xt, torch.from_numpy(gamma), torch.from_numpy(beta), 32,
                                     1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)


def _fused_inputs(rng, b, h, w, cin, cout, mean=0.0):
    """NHWC x with per-channel means about ``mean`` and a spread about 1, GN
    affine, HWIO kernel and bias, as numpy fp32."""
    x = (mean + rng.standard_normal((b, h, w, cin))
         + 0.5 * rng.standard_normal(cin)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / math.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, gamma, beta, k, bias


def _oihw(k, dtype):
    return torch.from_numpy(k).permute(3, 2, 0, 1).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_route_matches_jax_reference(dtype):
    """The card's route of the op (GN scale/shift, then the conv on x in its
    own type), with the conv kernel's plain version in the kernel's place,
    against JAX's ``_reference`` at dtype bf16, on x whose channels have a
    mean of about +40 and a spread of about 1: the trunks' first convs see
    such an fp32 x. Rounding x to bf16 before the affine (the route before
    this check) is off by up to 2^-9 * 40 / std in the normalised value:
    0.148 here. Held to 2^-6 of the largest output (2 to 4 bf16 ulps there):
    both sides round the activation and the output to bf16 once, at values
    that differ by fp32 rounding."""
    b, h, w, cin, cout, groups = 2, 8, 6, 64, 32, 32
    x, gamma, beta, k, bias = _fused_inputs(np.random.default_rng(3), b, h, w, cin, cout, 40.0)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jfc._reference(jx, jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(k),
                                    jnp.asarray(bias), groups, 1e-5, jnp.bfloat16))
    ref = ref.astype(np.float32)
    xt = nchw(np.asarray(jx.astype(jnp.float32))).to(dtype)
    xt = xt.contiguous(memory_format=torch.channels_last)
    out = fused_conv.fused_route(xt, torch.from_numpy(gamma), torch.from_numpy(beta),
                                 _oihw(k, torch.bfloat16),
                                 torch.from_numpy(bias).to(torch.bfloat16), groups, 1e-5,
                                 conv=fused_conv.fused_gn_silu_conv3x3_reference)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(out), ref, atol=2.0 ** -6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_conv_plain_matches_jax_pallas(dtype):
    """The conv kernel's plain version against JAX's ``_pallas_forward``
    (interpret mode) fed JAX's ``_gn_scale_shift``, on x and kernel in
    dtype: fp32 to summation order, bf16 to one rounding of the output (the
    two sum the bf16 products in another order)."""
    b, h, w, cin, cout, groups = 2, 6, 5, 64, 32, 8
    x, gamma, beta, k, bias = _fused_inputs(np.random.default_rng(4), b, h, w, cin, cout)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x, jdt)
    js, jt = jfc._gn_scale_shift(jx, jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-5)
    ref = np.asarray(jfc._pallas_forward(jx, js, jt, jnp.asarray(k, jdt), jnp.asarray(bias),
                                         interpret=True)).astype(np.float32)
    xt = nchw(np.asarray(jx.astype(jnp.float32))).to(dtype)
    s, t = (torch.from_numpy(np.array(a)) for a in (js, jt))
    out = fused_conv.fused_gn_silu_conv3x3_reference(xt, s, t, _oihw(k, dtype),
                                                     torch.from_numpy(bias))
    assert out.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(nhwc(out), ref, atol=ATOL, rtol=1e-4)
    else:
        np.testing.assert_allclose(nhwc(out), ref, atol=2.0 ** -7 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 64, 64, 320, 320), (2, 32, 32, 1920, 640), (2, 8, 8, 1280, 1280),
    (1, 512, 512, 128, 128), (2, 16, 16, 1280, 1280), (4, 64, 64, 320, 320),
    (12, 8, 8, 1280, 1280), (2, 9, 7, 64, 40), (1, 1, 1, 32, 8), (3, 33, 17, 96, 136)])
def test_conv_splits_stay_in_range(b, h, w, cin, cout):
    """The conv kernel's plan: the pixel and Cout tiles cover the output
    exactly once, with Cout tiles of 160 where they divide Cout, else 128;
    the input channels are split only when the tiles do not fill the 132
    SMs, never into more parts than 64-channel slices or 16; and a split
    plan takes no more waves per unit of work than no split."""
    tiles_h, tiles_w, block_n, cout_tiles, splits = fused_conv.conv_plan(b, h, w, cin, cout)
    assert (tiles_h - 1) * fused_conv.TILE_H < h <= tiles_h * fused_conv.TILE_H
    assert (tiles_w - 1) * fused_conv.TILE_W < w <= tiles_w * fused_conv.TILE_W
    assert block_n == (160 if cout % 160 == 0 else 128)
    assert (cout_tiles - 1) * block_n < cout <= cout_tiles * block_n
    tiles = b * tiles_h * tiles_w * cout_tiles
    assert 1 <= splits <= min(16, -(-cin // 64))
    if tiles >= 132:
        assert splits == 1
    assert -(-tiles * splits // 132) / splits <= -(-tiles // 132)


@pytest.mark.parametrize("b,hw,c,itemsize", [
    (1, 512 * 512, 128, 2), (2, 64 * 64, 320, 2), (2, 8 * 8, 1280, 2), (4, 64 * 64, 320, 4),
    (2, 13 * 11, 320, 4), (1, 1, 32, 2)])
def test_gn_chunks_stay_in_range(b, hw, c, itemsize):
    """The statistics kernel's split of each image over blocks: at least one
    pixel and, unless the image is one chunk, 8 KB per block; about two
    blocks per SM over the batch, at most."""
    chunks = fused_conv.gn_chunks(b, hw, c, itemsize)
    assert 1 <= chunks <= hw
    assert chunks == 1 or hw * c * itemsize // chunks >= 8192
    assert b * chunks < 2 * 132 + b


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches on CUDA tensors or raises; it never runs
    the plain version in its place."""
    q = torch.zeros((1, 1, 64, 40), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_cuda(q, q, q, 0.1)
    x = torch.zeros((1, 32, 4, 4), dtype=torch.bfloat16)
    s = torch.zeros((1, 32))
    w = torch.zeros((8, 32, 3, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.fused_gn_silu_conv3x3(x, s, s, w, torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.gn_scale_shift_cuda(x, torch.ones(32), torch.zeros(32), 8, 1e-5)


def test_kernel_alignment_check():
    """The kernels move 16 bytes per thread: a view that starts off a
    16-byte boundary is refused before launch."""
    from edgestyle_tpu_torch import kernels

    base = torch.zeros(64, dtype=torch.bfloat16)
    kernels.check_aligned("k", a=base, b=base[8:])
    with pytest.raises(ValueError, match="b not 16-byte aligned"):
        kernels.check_aligned("k", a=base, b=base[1:])


# ------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("nq,nk,d,dtype,impl", [
    (4096, 4096, 40, torch.bfloat16, "flash"), (1024, 1024, 80, torch.bfloat16, "flash"),
    (4096, 4096, 512, torch.bfloat16, "plain"), (4096, 77, 40, torch.bfloat16, "plain"),
    (256, 256, 160, torch.bfloat16, "plain"), (1024, 1024, 36, torch.bfloat16, "plain"),
    (4096, 4096, 40, torch.float32, "flash"), (1024, 1024, 80, torch.float32, "flash")])
def test_attention_dispatch_rule_on_card(cuda, nq, nk, d, dtype, impl):
    """On the card: the flash kernels for q of any float type with nq == nk
    >= 1024 and head dim % 8 == 0 up to their limit of 128 (the VAE's
    single 512 head stays plain)."""
    assert pick_impl(torch.zeros(1, device=cuda, dtype=dtype), nq, nk, d) == impl


@pytest.mark.gpu
def test_fp32_multi_head_attention_runs_kernels_on_card(cuda):
    """An fp32 model's long self-attention on the card runs the forward, dq
    and dk/dv kernels once each on q, k, v and dO rounded to bf16; the
    output and the gradients come back fp32 and agree with the plain fp32
    version within the kernels' card tolerances (REL_TOL forward,
    BWD_REL_TOL backward, of the largest plain value)."""
    from edgestyle_tpu_torch import kernels

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, g = (torch.randn((2, 1024, 160), generator=gen, device=cuda) for _ in range(4))
    d = 80

    def run(attend):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attend(*leaves)
        return (out, *torch.autograd.grad(out, leaves, g))

    def plain(*qkv):
        heads = [t.reshape(2, -1, 2, d).transpose(1, 2) for t in qkv]
        out = flash.flash_attention_reference(*heads, d ** -0.5)
        return out.transpose(1, 2).reshape(2, -1, 160)

    before = dict(kernels.LAUNCHES)
    got = run(lambda *qkv: multi_head_attention(*qkv, 2))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.LAUNCHES[name] == before[name] + 1, name
    ref = run(plain)
    for a, r, tol in zip(got, ref, (2.0 ** -6, *(2.0 ** -5,) * 3)):
        assert a.dtype == torch.float32
        assert (a - r).abs().max().item() <= tol * r.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_fp32_norm_act_conv3x3_takes_plain_route_on_card(cuda, x_dtype):
    """An fp32 weight on the card takes the plain version (no kernel
    launch) and the op returns its fp32 dtype, equal to the plain version;
    and a bf16 weight with dtype fp32 takes the kernels and still returns
    fp32."""
    from edgestyle_tpu_torch import kernels

    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 64, 16, 16), generator=gen, device=cuda).to(x_dtype)
    gamma = 1.0 + 0.1 * torch.randn((64,), generator=gen, device=cuda)
    beta = 0.1 * torch.randn((64,), generator=gen, device=cuda)
    wt = (torch.randn((32, 64, 3, 3), generator=gen, device=cuda) / 24.0)
    wt = wt.contiguous(memory_format=torch.channels_last)
    bias = 0.1 * torch.randn((32,), generator=gen, device=cuda)
    before = dict(kernels.LAUNCHES)
    out = fused_conv.norm_act_conv3x3(x, gamma, beta, wt, bias, num_groups=32,
                                      dtype=torch.float32)
    assert kernels.LAUNCHES == before
    assert out.dtype == torch.float32
    ref = fused_conv.norm_act_conv3x3_reference(x, gamma, beta, wt, bias, 32, 1e-5,
                                                torch.float32)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    out = fused_conv.norm_act_conv3x3(x, gamma, beta, wt.to(torch.bfloat16), bias,
                                      num_groups=32, dtype=torch.float32)
    assert kernels.LAUNCHES["fused_gn_silu_conv3x3"] == before["fused_gn_silu_conv3x3"] + 1
    assert out.dtype == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(1024, 40), (1024, 80), (1000, 64), (4096, 40), (1000, 40),
                                 (1024, 128), (1024, 8)])
def test_flash_kernel_matches_plain_on_card(cuda, n, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 4, n, d), generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash.flash_attention_cuda(q, k, v, scale)
    ref = flash.flash_attention_reference(q, k, v, scale)
    # The output is a softmax mix of n random v, ~N(0, e/n): far below |v|.
    # Hold it to 2^-6 of its largest value, 2 to 4 bf16 ulps there.
    atol = 2.0 ** -6 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, flash.flash_attention_reference_lse(q, k, scale),
                               atol=1e-3, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,cin,h,w,cout,dtype", [
    (2, 64, 9, 7, 40, torch.bfloat16), (1, 320, 16, 16, 640, torch.bfloat16),
    (2, 128, 40, 24, 256, torch.bfloat16), (2, 64, 9, 7, 40, torch.float32),
    (2, 320, 24, 20, 320, torch.float32)])
def test_fused_conv_kernel_matches_plain_on_card(cuda, b, cin, h, w, cout, dtype):
    """The op on the card (statistics kernel, conv kernel on x in its own
    type) against the plain op. Includes a large GN shift: a padded tap must
    load 0, not silu(t); and fp32 x with channel means of +40, which the
    conv must normalise from its fp32 values."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, cin, h, w), generator=gen, device=cuda)
    if dtype == torch.float32:
        x = x + 40.0
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    gamma = torch.randn((cin,), generator=gen, device=cuda)
    beta = 3.0 + torch.randn((cin,), generator=gen, device=cuda)
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=cuda) / math.sqrt(9 * cin))
    wt = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias = torch.randn((cout,), generator=gen, device=cuda)
    out = fused_conv.norm_act_conv3x3(x, gamma, beta, wt, bias, num_groups=32,
                                      dtype=torch.bfloat16)
    ref = fused_conv.norm_act_conv3x3_reference(x, gamma, beta, wt, bias, 32, 1e-5,
                                                torch.bfloat16)
    # bf16 outputs |y| < 16 plus 1-ulp activation roundings
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-1, rtol=0)


def _gn_tolerance(x, num_groups):
    """Relative tolerance of the statistics kernel's s against the plain
    statistics, per channel, and |mean| per channel: fp32 sums in another
    order, 1e-4 relative; for bf16 x the single-pass variance E[x^2] -
    E[x]^2 loses mean^2 / var of it to cancellation, 2e-6 of that ratio at
    these sizes. t = beta - mean * s is held to rtol * |mean * s| + 1e-5."""
    b, c = x.shape[:2]
    xf = x.float().permute(0, 2, 3, 1).reshape(b, -1, num_groups, c // num_groups)
    mean, var = xf.mean(dim=(1, 3)), xf.var(dim=(1, 3))
    ratio = (mean.square() / var).repeat_interleave(c // num_groups, dim=1)
    mean_c = mean.repeat_interleave(c // num_groups, dim=1)
    rtol = 1e-4 + (2e-6 * ratio if x.dtype == torch.bfloat16 else 0.0)
    return rtol, mean_c.abs()


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,mean,eps,dtype", [
    (2, 320, 13, 11, 0.0, 1e-5, torch.bfloat16), (2, 320, 13, 11, 40.0, 1e-6, torch.bfloat16),
    (2, 320, 13, 11, 40.0, 1e-6, torch.float32), (1, 128, 100, 90, 0.0, 1e-6, torch.float32),
    (2, 1280, 8, 8, 1.0, 1e-5, torch.bfloat16), (1, 2560, 7, 5, 40.0, 1e-5, torch.float32)])
def test_gn_scale_shift_kernel_matches_plain_on_card(cuda, b, c, h, w, mean, eps, dtype):
    """The statistics kernel against its plain version: bf16 and fp32 x,
    channel means of 0 and +40 (where bf16's single-pass variance cancels),
    eps 1e-6 and 1e-5, H*W a multiple of no tile. Twice, to show the sums
    are deterministic."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (mean + torch.randn((b, c, h, w), generator=gen, device=cuda)
         + 0.5 * torch.randn((1, c, 1, 1), generator=gen, device=cuda))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    gamma = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=cuda)
    beta = 0.1 * torch.randn((c,), generator=gen, device=cuda)
    s, t = fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps)
    s2, t2 = fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps)
    assert torch.equal(s, s2) and torch.equal(t, t2)
    rs, rt = fused_conv.gn_scale_shift_reference(x, gamma, beta, 32, eps)
    rtol, mean_abs = _gn_tolerance(x, 32)
    assert ((s - rs).abs() <= rtol * rs.abs()).all()
    assert ((t - rt).abs() <= rtol * mean_abs * rs.abs() + 1e-5).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bh,n,d", [(2, 1000, 64), (4, 256, 40), (16, 4096, 40), (16, 1024, 80)])
def test_flash_backward_kernels_match_plain_on_card(cuda, bh, n, d):
    """flash_bwd_dq and flash_bwd_dkv against the plain backward on the same
    forward output and lse, at small shapes (one with a ragged last tile)
    and the SD1.5 ones. Each gradient is held to 2^-5 of its largest value:
    the kernels round P to bf16 for dv (the plain version keeps it fp32)
    and sum in another order, a few bf16 ulps of the largest gradient."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, g = (torch.randn((1, bh, n, d), generator=gen, device=cuda).to(torch.bfloat16)
                  for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash.flash_attention_cuda(q, k, v, scale)
    got = flash.flash_attention_backward_cuda(q, k, v, out, lse, g, scale)
    ref = flash.flash_attention_backward_reference(q, k, v, out, lse, g, scale)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        atol = 2.0 ** -5 * r.float().abs().max().item()
        torch.testing.assert_close(a.float(), r.float(), atol=atol, rtol=0, msg=name)


@pytest.mark.gpu
def test_flash_autograd_function_matches_plain_on_card(cuda):
    """Autograd through flash_attention on bf16 CUDA tensors (the
    FlashAttention Function: forward kernel, both backward kernels) against
    autograd through the plain version, same inputs and output gradient."""
    from edgestyle_tpu_torch import kernels

    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, g = (torch.randn((2, 4, 1024, 40), generator=gen, device=cuda).to(torch.bfloat16)
                  for _ in range(4))
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = dict(kernels.LAUNCHES)
        if route == "kernel":
            out = flash.flash_attention(*leaves, scale=40 ** -0.5)
        else:
            out = flash.flash_attention_reference(*leaves, 40 ** -0.5)
        out.backward(g)
        launched = {n: kernels.LAUNCHES[n] - before[n]
                    for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        assert launched == ({n: 1 for n in launched} if route == "kernel"
                            else {n: 0 for n in launched})
        grads[route] = [t.grad.float() for t in leaves]
    for name, a, r in zip("qkv", grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, r, atol=2.0 ** -5 * r.abs().max().item(), rtol=0, msg=name)


@pytest.mark.gpu
def test_norm_act_conv_autograd_function_matches_plain_on_card(cuda):
    """Autograd through norm_act_conv3x3 on bf16 CUDA tensors (the
    NormActConv3x3 Function: the kernel forward, the plain version's vjp
    backward) against autograd through the plain version, all five inputs."""
    from edgestyle_tpu_torch import kernels

    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((2, 64, 16, 16), generator=gen, device=cuda).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    gamma = 1.0 + 0.1 * torch.randn((64,), generator=gen, device=cuda)
    beta = 0.1 * torch.randn((64,), generator=gen, device=cuda)
    wt = (torch.randn((32, 64, 3, 3), generator=gen, device=cuda) / 24.0).to(torch.bfloat16)
    wt = wt.contiguous(memory_format=torch.channels_last)
    bias = 0.1 * torch.randn((32,), generator=gen, device=cuda)
    g = torch.randn((2, 32, 16, 16), generator=gen, device=cuda).to(torch.bfloat16)
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta, wt, bias)]
        leaves[0] = leaves[0].detach().contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        leaves[3] = leaves[3].detach().contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        before = kernels.LAUNCHES["fused_gn_silu_conv3x3"]
        if route == "kernel":
            out = fused_conv.norm_act_conv3x3(*leaves, num_groups=32, dtype=torch.bfloat16)
        else:
            out = fused_conv.norm_act_conv3x3_reference(*leaves, 32, 1e-5, torch.bfloat16)
        out.backward(g)
        assert kernels.LAUNCHES["fused_gn_silu_conv3x3"] - before == (route == "kernel")
        grads[route] = [t.grad.float() for t in leaves]
    # the backward is the same plain vjp on the same saved inputs; cuDNN may
    # sum a weight gradient in another order from call to call: 2^-7 of the
    # largest value, one or two bf16 ulps there
    for name, a, r in zip(("x", "gamma", "beta", "weight", "bias"), grads["kernel"],
                          grads["plain"]):
        torch.testing.assert_close(a, r, atol=2.0 ** -7 * r.abs().max().item(), rtol=0,
                                   msg=name)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_inputs_that_require_grad_on_card(cuda):
    """The raw wrappers write through pointers, which autograd cannot see:
    they raise when a graph would be recorded, so no caller cuts it."""
    q = torch.zeros((1, 1, 64, 40), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        flash.flash_attention_cuda(q, q, q, 0.1)
    x = torch.zeros((1, 32, 4, 4), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    s = torch.zeros((1, 32), device=cuda)
    w = torch.zeros((8, 32, 3, 3), device=cuda, dtype=torch.bfloat16)
    w = w.contiguous(memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="autograd"):
        fused_conv.fused_gn_silu_conv3x3(x, s, s, w, torch.zeros(8, device=cuda))
    with pytest.raises(RuntimeError, match="autograd"):
        fused_conv.gn_scale_shift_cuda(x, torch.ones(32, device=cuda),
                                       torch.zeros(32, device=cuda), 8, 1e-5)
    with torch.no_grad():
        flash.flash_attention_cuda(q, q, q, 0.1)

"""Parity of the PyTorch port's ops (edgestyle_tpu_torch.ops) with the JAX
package's, on the CPU in fp32, and of its CUDA kernels with their plain
versions on the card (skipped without one).

The same numpy inputs, made from a seed, go through both sides. The JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU.
"""

import functools
import math

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
    """CPU tensors always take the plain version; the flash kernel is only
    for CUDA tensors with nq == nk >= 1024 and head dim % 8 == 0."""
    cpu = torch.zeros(1)
    assert pick_impl(cpu, 4096, 4096, 40) == "plain"
    meta = torch.zeros(1, device="meta")
    assert pick_impl(meta, 4096, 4096, 40) == "plain"


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


@pytest.mark.parametrize("m,cin,cout", [
    (2 * 64 * 64, 320, 320), (2 * 32 * 32, 1920, 640), (2 * 8 * 8, 1280, 1280),
    (512 * 512, 128, 128), (12 * 8 * 8, 1280, 1280), (7, 32, 8)])
def test_conv_splits_stay_in_range(m, cin, cout):
    """The split-K count: 1 once the 128x128 tiles fill the 132 SMs; else
    enough splits to fill them, unless capped at 16 or at an eighth of the
    K slices (the kernel refuses more splits than slices)."""
    splits = fused_conv.conv_splits(m, cin, cout)
    tiles = -(-m // 128) * -(-cout // 128)
    cap = min(16, max(1, 9 * cin // (64 if cin % 64 == 0 else 32) // 8))
    assert 1 <= splits <= cap
    if tiles >= 132:
        assert splits == 1
    else:
        assert tiles * splits >= 132 or splits == cap


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
@pytest.mark.parametrize("nq,nk,d,impl", [
    (4096, 4096, 40, "flash"), (1024, 1024, 80, "flash"), (4096, 4096, 512, "plain"),
    (4096, 77, 40, "plain"), (256, 256, 160, "plain"), (1024, 1024, 36, "plain")])
def test_attention_dispatch_rule_on_card(cuda, nq, nk, d, impl):
    """On the card: the flash kernel for nq == nk >= 1024 and head dim % 8
    == 0 up to its limit of 128 (the VAE's single 512 head stays plain)."""
    assert pick_impl(torch.zeros(1, device=cuda), nq, nk, d) == impl


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(1024, 40), (1024, 80), (1000, 64)])
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
@pytest.mark.parametrize("b,cin,h,w,cout", [(2, 64, 9, 7, 40), (1, 320, 16, 16, 640), (2, 128, 40, 24, 256)])
def test_fused_conv_kernel_matches_plain_on_card(cuda, b, cin, h, w, cout):
    """Includes a large GN shift: a padded tap must load 0, not silu(t)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, cin, h, w), generator=gen, device=cuda).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
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

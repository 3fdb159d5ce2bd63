"""The flash backward kernels' arithmetic (``kernels/flash_bwd.cu``,
``flash_bwd_dq`` and ``flash_bwd_dkv``), emulated in plain torch on the CPU,
against the JAX Pallas backward (interpret mode) and the port's plain
version.

The kernels cannot run here, but their numerics can. Both take P =
exp2(S * c - L * log2 e) with c = scale * log2 e folded into one multiply-add
and dS = P * (dP - D), with S and dP in fp32, and sum in fp32 over their
steps:
- dq: blocks of 128 query rows, keys in steps of 64; dS rounded to bf16 per
  step before dS K; dQ scaled once at the end.
- dk/dv: blocks of 128 key rows, queries in steps of 64 (S^T = K Q^T, dP^T =
  V dO^T); P^T and dS^T rounded to bf16 per step before the dV and dK
  products; dK scaled once at the end.
A ragged last block or step is a shorter slice (the kernels' masks). The
emulations are held to the tolerance the card holds the kernels to
(``chip_smoke.BWD_REL_TOL``: 2^-5 of the largest gradient) on bf16 inputs.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgestyle_tpu.ops.flash as jflash
from edgestyle_tpu_torch.ops import flash
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

BWD_REL_TOL = 2.0 ** -5
BLOCK, STEP = 128, 64  # rows a block owns, rows of the other axis per step
LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
NAMES = {"dq": ("dq",), "dkv": ("dk", "dv")}


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def _consts(lse, scale):
    return torch.tensor(scale * math.log2(math.e), dtype=torch.float32), -(lse.float() * LOG2E)


def dq_emulation(q, k, v, dout, lse, delta, scale: float):
    """(dq,) of (B, H, N, D) bf16 q, k, v, dO, fp32 (B, H, N) lse and D, in
    the kernel's tile order and roundings."""
    c, nl = _consts(lse, scale)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    n = q.shape[-2]
    dq = torch.zeros_like(qf)
    for q0 in range(0, n, BLOCK):
        rows = slice(q0, q0 + BLOCK)
        acc = torch.zeros_like(qf[..., rows, :])
        for k0 in range(0, n, STEP):
            keys = slice(k0, k0 + STEP)
            s = qf[..., rows, :] @ kf[..., keys, :].transpose(-1, -2)
            p = torch.exp2(torch.addcmul(nl[..., rows, None], s, c))
            dp = dof[..., rows, :] @ vf[..., keys, :].transpose(-1, -2)
            ds = p * (dp - delta.float()[..., rows, None])
            acc += ds.to(torch.bfloat16).float() @ kf[..., keys, :]
        dq[..., rows, :] = acc * scale
    return (dq.to(torch.bfloat16),)


def dkv_emulation(q, k, v, dout, lse, delta, scale: float):
    """(dk, dv) of (B, H, N, D) bf16 q, k, v, dO, fp32 (B, H, N) lse and D,
    in the kernel's tile order and roundings."""
    c, nl = _consts(lse, scale)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    n = q.shape[-2]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, n, BLOCK):
        keys = slice(k0, k0 + BLOCK)
        dk_acc = torch.zeros_like(kf[..., keys, :])
        dv_acc = torch.zeros_like(vf[..., keys, :])
        for q0 in range(0, n, STEP):
            qs = slice(q0, q0 + STEP)
            st = kf[..., keys, :] @ qf[..., qs, :].transpose(-1, -2)
            p = torch.exp2(torch.addcmul(nl[..., None, qs], st, c))
            dpt = vf[..., keys, :] @ dof[..., qs, :].transpose(-1, -2)
            ds = p * (dpt - delta.float()[..., None, qs])
            dv_acc += p.to(torch.bfloat16).float() @ dof[..., qs, :]
            dk_acc += ds.to(torch.bfloat16).float() @ qf[..., qs, :]
        dk[..., keys, :] = dk_acc * scale
        dv[..., keys, :] = dv_acc
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


EMULATION = {"dq": dq_emulation, "dkv": dkv_emulation}


def _plain(kernel, *args):
    """The port's plain version of `kernel`, as a tuple of fp32 arrays."""
    if kernel == "dq":
        ref = (flash.flash_bwd_dq_reference(*args),)
    else:
        ref = flash.flash_bwd_dkv_reference(*args)
    return tuple(t.float().numpy() for t in ref)


@functools.lru_cache(maxsize=None)
def _inputs(seed: int, n: int, d: int):
    """bf16 q, k, v, dO (B=1, H=2) from a seeded numpy draw, the forward's
    output and lse from the plain forward, and D = rowsum(dO * O)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, n, d)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out = flash.flash_attention_reference(q, k, v, scale)
    lse = flash.flash_attention_reference_lse(q, k, scale)
    return q, k, v, g, out, lse, flash.flash_bwd_delta(out, g), scale


@functools.lru_cache(maxsize=None)
def _pallas_backward(seed: int, n: int, d: int):
    """JAX's _flash_backward (dq, dk, dv as fp32 arrays) on _inputs(seed, n,
    d): one interpret-mode run serves both kernels' cases. Call it under the
    pallas_interpret fixture."""
    q, k, v, g, out, lse, _, scale = _inputs(seed, n, d)
    jq, jk, jv, jg, jout = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (q, k, v, g, out))
    grads = jflash._flash_backward(jq, jk, jv, jout, jnp.asarray(lse.numpy()), jg, scale)
    return {name: np.asarray(x.astype(jnp.float32)) for name, x in zip(("dq", "dk", "dv"), grads)}


def _assert_close(kernel, got, ref, what):
    for name, a, r in zip(NAMES[kernel], got, ref):
        r = np.asarray(r, dtype=np.float32)
        np.testing.assert_allclose(a.float().numpy(), r, rtol=0,
                                   atol=BWD_REL_TOL * np.abs(r).max(), err_msg=f"{what} {name}")


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("d", [40, 80])
def test_bwd_arithmetic_matches_jax_pallas(pallas_interpret, d, n, kernel):
    """The emulation against JAX's _flash_backward (the Pallas dq and dk/dv
    kernels in interpret mode), fed the same bf16 inputs, forward output and
    lse."""
    q, k, v, g, out, lse, delta, scale = _inputs(n + d, n, d)
    jax_grads = _pallas_backward(n + d, n, d)
    got = EMULATION[kernel](q, k, v, g, lse, delta, scale)
    _assert_close(kernel, got, [jax_grads[name] for name in NAMES[kernel]], "vs Pallas")


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d", [8, 40, 80])
def test_bwd_arithmetic_matches_plain_on_ragged_tiles(d, kernel):
    """At N = 1000 (a ragged last block and step; the Pallas blocks must
    divide N, so JAX cannot take it) the emulation against the port's plain
    version of the kernel. D = 8 is the smallest head dim the kernels take."""
    q, k, v, g, out, lse, delta, scale = _inputs(d, 1000, d)
    got = EMULATION[kernel](q, k, v, g, lse, delta, scale)
    _assert_close(kernel, got, _plain(kernel, q, k, v, g, lse, delta, scale), "vs plain")

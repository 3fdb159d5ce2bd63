"""The flash dk/dv backward kernel's arithmetic (``kernels/flash_bwd.cu``,
``flash_bwd_dkv``), emulated in plain torch on the CPU, against the JAX
Pallas backward (interpret mode) and the port's plain version.

The kernel cannot run here, but its numerics can: blocks of 128 key rows,
queries in steps of 64, S^T = K Q^T and dP^T = V dO^T in fp32, P^T =
exp2(S^T * c - L * log2 e) with c = scale * log2 e folded into one
multiply-add, dS^T = P^T * (dP^T - D), P^T and dS^T rounded to bf16 per step
before the dV and dK products, fp32 sums over the steps, dK scaled once at
the end. A ragged last step is a shorter slice (the kernel's mask). The
emulation is held to the tolerance the card holds the kernel to
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

BWD_REL_TOL = 2.0 ** -5
BLOCK_K, STEP_Q = 128, 64
LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def dkv_emulation(q, k, v, dout, lse, delta, scale: float):
    """(dk, dv) of (B, H, N, D) bf16 q, k, v, dO, fp32 (B, H, N) lse and D,
    in the kernel's tile order and roundings."""
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    nl = -(lse.float() * LOG2E)
    n = q.shape[-2]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, n, BLOCK_K):
        keys = slice(k0, k0 + BLOCK_K)
        dk_acc = torch.zeros_like(kf[..., keys, :])
        dv_acc = torch.zeros_like(vf[..., keys, :])
        for q0 in range(0, n, STEP_Q):
            qs = slice(q0, q0 + STEP_Q)
            st = kf[..., keys, :] @ qf[..., qs, :].transpose(-1, -2)
            p = torch.exp2(torch.addcmul(nl[..., None, qs], st, c))
            dpt = vf[..., keys, :] @ dof[..., qs, :].transpose(-1, -2)
            ds = p * (dpt - delta.float()[..., None, qs])
            dv_acc += p.to(torch.bfloat16).float() @ dof[..., qs, :]
            dk_acc += ds.to(torch.bfloat16).float() @ qf[..., qs, :]
        dk[..., keys, :] = dk_acc * scale
        dv[..., keys, :] = dv_acc
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


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


def _assert_close(got, ref, what):
    for name, a, r in zip(("dk", "dv"), got, ref):
        r = np.asarray(r, dtype=np.float32)
        np.testing.assert_allclose(a.float().numpy(), r, rtol=0,
                                   atol=BWD_REL_TOL * np.abs(r).max(), err_msg=f"{what} {name}")


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("d", [40, 80])
def test_dkv_arithmetic_matches_jax_pallas(pallas_interpret, d, n):
    """The emulation against JAX's _flash_backward (the Pallas dq and dk/dv
    kernels in interpret mode), fed the same bf16 inputs, forward output and
    lse."""
    q, k, v, g, out, lse, delta, scale = _inputs(n + d, n, d)
    jq, jk, jv, jg, jout = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (q, k, v, g, out))
    _, jdk, jdv = jflash._flash_backward(jq, jk, jv, jout, jnp.asarray(lse.numpy()), jg, scale)
    got = dkv_emulation(q, k, v, g, lse, delta, scale)
    _assert_close(got, (jdk.astype(jnp.float32), jdv.astype(jnp.float32)), "vs Pallas")


@pytest.mark.parametrize("d", [40, 80])
def test_dkv_arithmetic_matches_plain_on_ragged_tiles(d):
    """At N = 1000 (a ragged last key block and query step; the Pallas
    blocks must divide N, so JAX cannot take it) the emulation against the
    port's plain flash_bwd_dkv_reference."""
    q, k, v, g, out, lse, delta, scale = _inputs(d, 1000, d)
    got = dkv_emulation(q, k, v, g, lse, delta, scale)
    ref = flash.flash_bwd_dkv_reference(q, k, v, g, lse, delta, scale)
    _assert_close(got, tuple(t.float().numpy() for t in ref), "vs plain")

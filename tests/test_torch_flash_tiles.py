"""The flash forward kernel's arithmetic (``kernels/flash_fwd.cu``), emulated
in plain torch on the CPU, against the JAX Pallas forward (interpret mode)
and the port's plain version.

The kernel cannot run here, but its numerics can: 128-key tiles, the
softmax in base 2 with scale * log2(e) folded into one multiply-add, the
running max and the rescale of the accumulator and the row sum, P rounded
to bf16 per tile before P V, and lse converted back to natural-log units
by ln 2. The emulation is held to the tolerances the card holds the kernel
to (``chip_smoke.py``: 2^-6 of the largest output, 1e-2 on lse), on bf16
inputs at the head dims the dispatch rule sends to the kernel and at a
ragged last tile (N = 1000).
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

REL_TOL = 2.0 ** -6
LSE_TOL = 1e-2
TILE = 128


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    yield


def kernel_emulation(q, k, v, scale: float):
    """(out, lse) of (B, H, N, D) bf16 q, k, v as the kernel computes them:
    fp32 logits per 128-key tile, p = exp2(s * c - m2) with c = scale *
    log2(e) and m2 the running max in base-2 units, l and the fp32
    accumulator rescaled by exp2(m2_old - m2_new), P rounded to bf16 before
    P V, out = acc / l in bf16, lse = (m2 + log2 l) * ln 2. A ragged last
    tile is a shorter slice (the kernel's -inf mask)."""
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    n = q.shape[-2]
    m2 = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(qf.shape)
    for t0 in range(0, n, TILE):
        s = qf @ kf[..., t0:t0 + TILE, :].transpose(-1, -2)
        mnew = torch.maximum(m2, s.amax(-1) * c)
        alpha = torch.exp2(m2 - mnew)
        p = torch.exp2(torch.addcmul(-mnew[..., None], s, c))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[..., t0:t0 + TILE, :]
        m2 = mnew
    out = (acc / l[..., None]).to(torch.bfloat16)
    return out, (m2 + torch.log2(l)) * math.log(2.0)


@pytest.mark.parametrize("n", [256, 1000])
@pytest.mark.parametrize("d", [40, 80, 8, 128])
def test_kernel_arithmetic_matches_jax_pallas(rng, pallas_interpret, d, n):
    b, h = 1, 2
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    scale = 1.0 / math.sqrt(d)
    ref, ref_lse = jflash._flash_forward(qj, kj, vj, scale, return_lse=True)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_lse = np.asarray(ref_lse)

    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (qj, kj, vj))
    out, lse = kernel_emulation(qt, kt, vt, scale)
    plain = flash.flash_attention_reference(qt, kt, vt, scale).float().numpy()
    plain_lse = flash.flash_attention_reference_lse(qt, kt, scale).numpy()
    out = out.float().numpy()
    lse = lse.numpy()

    atol = REL_TOL * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)
    np.testing.assert_allclose(lse, ref_lse, atol=LSE_TOL, rtol=0)
    np.testing.assert_allclose(out, plain, atol=REL_TOL * np.abs(plain).max(), rtol=0)
    np.testing.assert_allclose(lse, plain_lse, atol=LSE_TOL, rtol=0)

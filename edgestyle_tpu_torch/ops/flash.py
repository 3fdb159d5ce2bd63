"""Flash attention: the CUDA kernels, their plain versions and the autograd
Function that joins them.

Counterpart of edgestyle_tpu/ops/flash.py. The forward kernel is
``kernels/flash_fwd.cu`` (``_fwd_kernel``); the backward kernels are
``kernels/flash_bwd.cu`` (``_dq_kernel``, ``_dkv_kernel``).
:func:`flash_attention_reference` is the plain forward (the JAX package's
``_xla_attention``: fp32 logits and softmax, probabilities cast to v's dtype
before P*V) and :func:`flash_attention_backward_reference` the plain
backward (``_flash_backward``'s numerics). They are the CPU path and the
test oracles, never a fallback on the card.

:class:`FlashAttention` is the counterpart of the ``flash_attention`` custom
VJP and the one route of :func:`flash_attention`: its forward saves (q, k,
v, out, lse) and its backward recomputes P from them, through the kernels
for CUDA tensors and through the plain versions for CPU tensors. The raw
kernel wrappers refuse inputs that would record a graph, so no caller can
cut the graph by calling them directly.

The three launches are operators of ops/library.py (``edgestyle::flash_fwd``,
``flash_bwd_dq``, ``flash_bwd_dkv``), whose CUDA implementations are the
wrappers here, looked up when called; :class:`FlashAttention` reaches the
kernels through them alone, so ``torch.export`` traces each as one node.
"""

from __future__ import annotations

import torch

from edgestyle_tpu_torch import kernels
from edgestyle_tpu_torch.ops.library import define
from edgestyle_tpu_torch.ops.norms import F32, cast


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, H, N, D) tensors, fp32 logits."""
    logits = torch.matmul(cast(q, F32), cast(k, F32).transpose(-1, -2))
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.matmul(cast(probs, v.dtype), v)


def flash_attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                                  scale: float) -> torch.Tensor:
    """Row logsumexp of q k^T * scale, (B, H, N) fp32: what the kernel
    writes beside its output for the backward pass."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.logsumexp(logits, dim=-1)


def flash_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O), (B, H, N) fp32: one torch reduction, computed
    outside the kernels as the JAX package computes it outside Pallas."""
    return (dout.float() * out.float()).sum(-1)


def _bwd_ds(q, k, v, dout, lse, delta, scale: float):
    """fp32 P from lse and dS = P * (dO v^T - D) rounded to k's dtype, as
    both Pallas backward kernels recompute them."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, (p * (dp - delta.float()[..., None])).to(k.dtype)


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """Plain version of the dq kernel (``_dq_kernel``): dS k * scale."""
    _, ds = _bwd_ds(q, k, v, dout, lse, delta, scale)
    return (torch.matmul(ds.float(), k.float()) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale: float):
    """Plain version of the dk/dv kernel (``_dkv_kernel``): dS^T q * scale
    and P^T dO, with P kept fp32 (dO was cast to fp32)."""
    p, ds = _bwd_ds(q, k, v, dout, lse, delta, scale)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv) of softmax(q k^T * scale) v, (B, H, N, D) each, from the
    forward's output and row logsumexp, with ``_flash_backward``'s numerics:
    fp32 P from lse, dP from fp32 dO and v, dS rounded to k's dtype before
    the dq and dk products, P kept fp32 for dv; outputs in the inputs'
    dtypes."""
    delta = flash_bwd_delta(out, dout)
    return (flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale),
            *flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale))


def _check_kernel_inputs(what: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what} needs CUDA tensors")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{what} takes bf16 tensors, got {[t.dtype for t in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} writes through raw pointers and would cut the autograd "
                           f"graph: call flash_attention, whose autograd Function launches "
                           f"the backward kernels")
    shape = tensors[0].shape
    if any(t.shape != shape for t in tensors) or len(shape) != 4:
        raise ValueError(f"{what} needs equal (B, H, N, D) tensors, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    d = shape[-1]
    if d % 8 or d > 128:
        raise ValueError(f"{what} needs head dim % 8 == 0 and <= 128, got {d}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float):
    """Launch the forward kernel on (B, H, N, D) bf16 CUDA tensors; returns
    (out (B, H, N, D) bf16, lse (B, H, N) fp32)."""
    _check_kernel_inputs("flash_attention_cuda", q, k, v)
    b, h, n, d = q.shape
    qf = q.reshape(b * h, n, d).contiguous()
    kf = k.reshape(b * h, n, d).contiguous()
    vf = v.reshape(b * h, n, d).contiguous()
    out = torch.empty_like(qf)
    lse = torch.empty((b * h, n), device=q.device, dtype=torch.float32)
    kernels.check_aligned("flash_fwd", q=qf, k=kf, v=vf)
    lib = kernels.library("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), b * h, n, d, float(scale), stream)
    kernels.check(err, "flash_fwd")
    kernels.LAUNCHES["flash_fwd"] += 1
    return out.view(b, h, n, d), lse.view(b, h, n)


def _bwd_args(what: str, q, k, v, dout, lse, delta):
    """Checks and (BH, N, D) / (BH, N) contiguous views for the backward
    kernels."""
    _check_kernel_inputs(what, q, k, v, dout)
    b, h, n, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, n) or t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{what}: {name} must be fp32 CUDA ({b}, {h}, {n}), got "
                             f"{tuple(t.shape)} {t.dtype}")
    qf, kf, vf, dof = (t.reshape(b * h, n, d).contiguous() for t in (q, k, v, dout))
    rows = (lse.reshape(b * h, n).contiguous(), delta.reshape(b * h, n).contiguous())
    kernels.check_aligned(what, q=qf, k=kf, v=vf, dout=dof, lse=rows[0], delta=rows[1])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (qf, kf, vf, dof, *rows), stream


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """Launch the dq kernel on (B, H, N, D) bf16 CUDA tensors, the forward's
    lse and D (fp32 (B, H, N)); returns dq, bf16."""
    ins, stream = _bwd_args("flash_bwd_dq", q, k, v, dout, lse, delta)
    dq = torch.empty_like(ins[0])
    b, h, n, d = q.shape
    err = kernels.library("flash_bwd").flash_bwd_dq(
        *(t.data_ptr() for t in ins), dq.data_ptr(), b * h, n, d, float(scale), stream)
    kernels.check(err, "flash_bwd_dq")
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq.view(b, h, n, d)


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, scale: float):
    """Launch the dk/dv kernel on the same inputs; returns (dk, dv), bf16."""
    ins, stream = _bwd_args("flash_bwd_dkv", q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
    b, h, n, d = q.shape
    err = kernels.library("flash_bwd").flash_bwd_dkv(
        *(t.data_ptr() for t in ins), dk.data_ptr(), dv.data_ptr(), b * h, n, d, float(scale),
        stream)
    kernels.check(err, "flash_bwd_dkv")
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk.view(b, h, n, d), dv.view(b, h, n, d)


def _fwd_fake(q, k, v, scale):
    _check_kernel_inputs("flash_fwd", q, k, v)
    return q.new_empty(q.shape), q.new_empty(q.shape[:3], dtype=torch.float32)


def _bwd_fake_args(what, q, k, v, dout, lse, delta):
    _check_kernel_inputs(what, q, k, v, dout)
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"{what}: lse and delta must be {tuple(q.shape[:3])}")


def _dq_fake(q, k, v, dout, lse, delta, scale):
    _bwd_fake_args("flash_bwd_dq", q, k, v, dout, lse, delta)
    return q.new_empty(q.shape)


def _dkv_fake(q, k, v, dout, lse, delta, scale):
    _bwd_fake_args("flash_bwd_dkv", q, k, v, dout, lse, delta)
    return q.new_empty(q.shape), q.new_empty(q.shape)


def _attention_flops(per_head: int):
    """N^2 D products times ``per_head`` for (B, H, N, D) q."""
    def flops(q, *args, out_shape=None, **kwargs) -> int:
        b, h, n, d = q
        return per_head * b * h * n * n * d
    return flops


# The CUDA implementations look the wrappers up when called, so a caller
# that swaps a wrapper (chip_smoke's planted faults) swaps the operator's.
FLASH_FWD = define("flash_fwd", "(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)",
                   lambda *a: flash_attention_cuda(*a), _fwd_fake, _attention_flops(4))
FLASH_BWD_DQ = define(
    "flash_bwd_dq",
    "(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor delta, float scale) -> Tensor",
    lambda *a: flash_bwd_dq_cuda(*a), _dq_fake, _attention_flops(6))
FLASH_BWD_DKV = define(
    "flash_bwd_dkv",
    "(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor delta, float scale) "
    "-> (Tensor, Tensor)",
    lambda *a: flash_bwd_dkv_cuda(*a), _dkv_fake, _attention_flops(8))


def flash_attention_backward_cuda(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv), bf16, through the two backward operators, from the
    forward's output and lse."""
    delta = flash_bwd_delta(out, dout)
    return (FLASH_BWD_DQ(q, k, v, dout, lse, delta, scale),
            *FLASH_BWD_DKV(q, k, v, dout, lse, delta, scale))


class FlashAttention(torch.autograd.Function):
    """The flash_attention custom VJP. On CUDA tensors the forward and
    backward launch the kernels through their operators; on CPU tensors
    they run the plain versions of the same two functions. The kernels multiply bf16 operands, so on
    the card q, k, v of another type (an fp32 model's) are rounded to bf16
    on the way in, as is dO; logits, softmax and sums stay fp32, and the
    output and the gradients are returned in the inputs' types."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.scale = scale
        if q.is_cuda:
            q, k, v = (cast(t, torch.bfloat16) for t in (q, k, v))
            out, lse = FLASH_FWD(q, k, v, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            return cast(out, ctx.dtypes[0])
        out = flash_attention_reference(q, k, v, scale)
        lse = flash_attention_reference_lse(q, k, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            grads = flash_attention_backward_cuda(q, k, v, out, lse, dout.to(q.dtype),
                                                  ctx.scale)
        else:
            grads = flash_attention_backward_reference(q, k, v, out, lse, dout, ctx.scale)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float = 1.0) -> torch.Tensor:
    """softmax(q k^T * scale) v, (B, H, N, D), through
    :class:`FlashAttention`: the kernels for CUDA tensors, the plain
    versions for CPU tensors."""
    return FlashAttention.apply(q, k, v, scale)

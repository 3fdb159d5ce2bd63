"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of edgestyle_tpu/ops/flash.py (``_fwd_kernel`` /
``_flash_forward`` / ``flash_attention``). The kernel is
``kernels/flash_fwd.cu``; :func:`flash_attention_reference` is the plain
PyTorch version of the same function (the JAX package's ``_xla_attention``:
fp32 logits and softmax, probabilities cast to v's dtype before P*V). It is
the CPU path and the test oracle, never a fallback on the card.

The backward kernels (``_dq_kernel``, ``_dkv_kernel``) belong to the
training slice and are not ported yet.
"""

from __future__ import annotations

import torch

from edgestyle_tpu_torch import kernels


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, H, N, D) tensors, fp32 logits."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def flash_attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                                  scale: float) -> torch.Tensor:
    """Row logsumexp of q k^T * scale, (B, H, N) fp32: what the kernel
    writes beside its output for the backward pass."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.logsumexp(logits, dim=-1)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float):
    """Launch the kernel on (B, H, N, D) bf16 CUDA tensors; returns
    (out (B, H, N, D) bf16, lse (B, H, N) fp32)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 4:
        raise ValueError(f"flash kernel needs equal (B, H, N, D) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    if d % 8 or d > 128:
        raise ValueError(f"flash kernel needs head dim % 8 == 0 and <= 128, got {d}")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float = 1.0) -> torch.Tensor:
    """softmax(q k^T * scale) v, (B, H, N, D): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, scale)[0]
    return flash_attention_reference(q, k, v, scale)

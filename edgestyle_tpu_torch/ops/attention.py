"""Multi-head attention over flattened token axes.

Counterpart of edgestyle_tpu/ops/attention.py. Two implementations, picked
from the inputs alone:

  * ``flash``  -- the flash-attention kernels (ops/flash.py), for the long
                  spatial self-attentions: CUDA tensors of any float type
                  (as the reference's Pallas kernel takes any type), nq ==
                  nk >= 1024 and head dim % 8 == 0 (the JAX ``_pick_impl``
                  rule with the card in place of the TPU), up to the
                  kernel's head dim 128;
  * ``plain``  -- fp32 logits and softmax with ``torch.matmul`` (the JAX
                  ``_xla_attention``): the 77-token cross-attention, the
                  256- and 64-token levels, the VAE mid attention (one head
                  of 512) and every CPU tensor.
"""

from __future__ import annotations

import torch

from edgestyle_tpu_torch.ops.flash import flash_attention, flash_attention_reference


def pick_impl(q: torch.Tensor, nq: int, nk: int, d: int) -> str:
    if q.is_cuda and nq >= 1024 and nq == nk and d % 8 == 0 and d <= 128:
        return "flash"
    return "plain"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """q: (B, Nq, C); k, v: (B, Nk, C). Returns (B, Nq, C)."""
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    scale = 1.0 / (d ** 0.5)
    qh = q.reshape(b, nq, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, nk, num_heads, d).transpose(1, 2)
    vh = v.reshape(b, nk, num_heads, d).transpose(1, 2)
    if pick_impl(q, nq, nk, d) == "flash":
        out = flash_attention(qh, kh, vh, scale=scale)
    else:
        out = flash_attention_reference(qh, kh, vh, scale)
    return out.transpose(1, 2).reshape(b, nq, c)

"""ToMe-SD token merging for the UNet and ControlNet transformer blocks.

Counterpart of edgestyle_tpu/ops/tome.py (Token Merging for Stable
Diffusion, Bolya & Hoffman, arXiv:2303.17604): before a block's
self-attention the ``r`` most redundant spatial tokens merge into their most
similar neighbours, the attention runs on ``N - r`` tokens, and the result
is broadcast back to every source position. An opt-in serving knob, not a
reference feature.

The same design as the JAX package, in PyTorch ops (no kernel: the JAX
package runs it in XLA, outside any Pallas kernel):

* bipartite soft matching with a strided 2x2 destination grid: dst is the
  top-left token of every 2x2 tile, src the other three; deterministic;
* the ranking runs on the bf16 metric normalised by its fp32 norm, as JAX
  does, and the scores are fp32; both are the exact values rounded once
  (bf16 squares and products are exact, their sums are taken in fp64), so
  the card and the CPU, whose fp32 sums run in other orders, rank alike;
  ``argmax`` takes the first maximum and the descending order is a stable
  argsort, as ``jnp.argsort`` is stable (bf16 metrics give exact ties);
* the merge is a scatter-mean with fp32 sums (``index_add_``), the values in
  the input dtype;
* the unmerge is one row index per token and one gather, never a value
  scatter (torch's gather takes int64 indices).

The pair is exact for duplicate tokens, and ``r = 0`` returns identities.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ToMeConfig:
    """ratio: share of a level's N tokens to merge (capped at the src count,
    3N/4); min_tokens: merge only where N >= it (4096: SD1.5's 64x64 level
    alone); merge_mlp: also run the feed-forward on the merged tokens."""

    ratio: float = 0.5
    min_tokens: int = 4096
    merge_mlp: bool = False

    def applies(self, num_tokens: int) -> bool:
        return self.ratio > 0.0 and num_tokens >= self.min_tokens


@functools.lru_cache(maxsize=64)
def _dst_src_indices(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """dst = the top-left of each 2x2 tile, src = the rest (row-major).
    Kept per grid and device: a copy from pageable host memory to the card
    waits for the stream, and a merge per block would stall the host."""
    idx = np.arange(h * w).reshape(h, w)
    dst_mask = np.zeros((h, w), bool)
    dst_mask[::2, ::2] = True
    return (torch.as_tensor(idx[dst_mask].ravel(), device=device),
            torch.as_tensor(idx[~dst_mask].ravel(), device=device))


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), rows (B, M) -> (B, M, C)."""
    return torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))


def build_merge(metric: torch.Tensor, h: int, w: int,
                r: int) -> Tuple[Callable, Callable, int]:
    """(merge, unmerge, r_effective) from the similarity of ``metric`` (B,
    N, C), N == h * w.

    merge(x):   (B, N, C) -> (B, N - r, C): the kept src tokens, then the
                dst tokens with their merged src tokens averaged in;
    unmerge(y): (B, N - r, C) -> (B, N, C): each position reads the row that
                holds its value."""
    b, n, _ = metric.shape
    assert n == h * w, (n, h, w)
    dev = metric.device
    dst_idx, src_idx = _dst_src_indices(h, w, torch.device(dev))
    n_dst, n_src = dst_idx.shape[0], src_idx.shape[0]
    r = max(0, min(int(r), n_src))
    if r == 0:
        return (lambda x: x), (lambda y: y), 0

    m = metric.to(torch.bfloat16)
    # the fp32 norm as the exact one rounded (fp64 sums of bf16 squares), so
    # that no device's summation order moves a bf16 rounding of the metric
    norm = m.double().square().sum(dim=-1, keepdim=True).sqrt().float()
    m = m / (norm + 1e-6).to(torch.bfloat16)
    a, bm = m[:, src_idx].double(), m[:, dst_idx].double()
    scores = torch.matmul(a, bm.transpose(1, 2)).float()  # (B, n_src, n_dst)
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)  # the first maximum
    order = torch.argsort(-node_max, dim=-1, stable=True)  # (B, n_src)
    merged_src, kept_src = order[:, :r], order[:, r:]
    arange_src = torch.arange(n_src, device=dev).expand(b, -1)
    inv_order = torch.empty_like(order).scatter_(1, order, arange_src)
    dst_assign = torch.gather(node_idx, 1, merged_src)  # (B, r)
    flat_dst = (dst_assign + torch.arange(b, device=dev)[:, None] * n_dst).reshape(-1)
    counts = torch.zeros(b * n_dst, device=dev).index_add_(
        0, flat_dst, torch.ones(b * r, device=dev)).view(b, n_dst)

    def merge(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        x_src = x[:, src_idx]
        x_dst = x[:, dst_idx].float()
        kept = _take_rows(x_src, kept_src)
        merged = _take_rows(x_src, merged_src)
        dst_sum = torch.zeros((b * n_dst, c), device=x.device).index_add_(
            0, flat_dst, merged.reshape(b * r, c).float()).view(b, n_dst, c)
        x_dst = (x_dst + dst_sum) / (1.0 + counts)[..., None]
        return torch.cat([kept, x_dst.to(x.dtype)], dim=1)

    # the row of the merged sequence each position reads: dst d at
    # n_src - r + d, a merged src its dst's row, a kept src its own slot
    src_rows = torch.where(inv_order < r, (n_src - r) + node_idx,
                           torch.clamp(inv_order - r, min=0))
    rows = torch.empty((b, n), dtype=torch.long, device=dev)
    rows[:, dst_idx] = (n_src - r) + torch.arange(n_dst, device=dev)
    rows[:, src_idx] = src_rows

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return _take_rows(y, rows)

    return merge, unmerge, r

"""CLIP text encoder (the clip-vit-large-patch14 text tower used by SD1.5).

Counterpart of edgestyle_tpu/models/clip_text.py: 12 layers, width 768,
12 heads, quick-GELU, causal mask, final LayerNorm; the pipeline consumes
``last_hidden_state``. :class:`CLIPTextModelWithProjection` adds the
bias-free ``text_projection`` of prompt mining, and
:func:`port_clip_text_state_dict` maps an HF CLIPTextModel state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from edgestyle_tpu_torch.core import spans
from edgestyle_tpu_torch.core.params import param, sub
from edgestyle_tpu_torch.core.porting import KeyMapper
from edgestyle_tpu_torch.models.layers import column_parallel, dense, layer_norm_block, row_dense
from edgestyle_tpu_torch.ops import tp


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    intermediate_size: int = 3072
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _attention(p, x, causal_mask, cfg: CLIPTextConfig, dtype):
    c, h = cfg.hidden_size, cfg.num_heads
    d = c // h
    b, n, _ = x.shape
    q = dense(sub(p, "q_proj"), x, c, dtype)
    k = dense(sub(p, "k_proj"), x, c, dtype)
    v = dense(sub(p, "v_proj"), x, c, dtype)
    qh, kh, vh = (t.reshape(b, n, h, d).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    logits = logits * (d ** -0.5) + causal_mask
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    out = torch.matmul(probs, vh).transpose(1, 2).reshape(b, n, c)
    return dense(sub(p, "out_proj"), out, c, dtype)


def clip_layer(lp, x, mask, cfg: CLIPTextConfig, dtype):
    """One pre-LN encoder layer (quick-GELU MLP); ``mask`` is added to the
    attention logits: the causal mask here, zeros in the vision tower.
    Tensor-parallel where fc1 holds a shard (fc1 column-, fc2 row-parallel;
    the attention's q/k/v/out_proj match no rule of core/partitioning.py,
    as in the JAX package, and stay replicated)."""
    x = x + _attention(sub(lp, "self_attn"),
                       layer_norm_block(sub(lp, "layer_norm1"), x, cfg.layer_norm_eps),
                       mask, cfg, dtype)
    hdn = layer_norm_block(sub(lp, "layer_norm2"), x, cfg.layer_norm_eps)
    split = column_parallel(lp, "fc1", cfg.intermediate_size)
    if split:
        hdn = tp.copy_to_model(hdn)
    hdn = quick_gelu(dense(sub(lp, "fc1"), hdn, cfg.intermediate_size, dtype))
    return x + row_dense(sub(lp, "fc2"), hdn, cfg.hidden_size, dtype, split)


class CLIPTextEncoder:
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(),
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype

    def __call__(self, p, input_ids: torch.Tensor):
        """input_ids (B, n) int -> {'last_hidden_state': (B, n, C),
        'pooled_output': (B, C) at the argmax (EOS) token}."""
        with spans.span(spans.CLIP):
            cfg, dt = self.cfg, self.dtype
            table = param(sub(p, "token_embedding"), "embedding",
                          (cfg.vocab_size, cfg.hidden_size), "embed")
            pos = param(p, "position_embedding", (cfg.max_positions, cfg.hidden_size),
                        "normal0.01")
            n = input_ids.shape[1]
            x = table.to(dt)[input_ids] + pos[None, :n].to(dt)
            mask = torch.triu(torch.full((n, n), float("-inf"), device=x.device), diagonal=1)
            for i in range(cfg.num_layers):
                x = clip_layer(sub(p, f"layers_{i}"), x, mask[None, None], cfg, dt)
            x = layer_norm_block(sub(p, "final_layer_norm"), x, cfg.layer_norm_eps)
            eos = input_ids.argmax(dim=-1)
            pooled = x[torch.arange(x.shape[0], device=x.device), eos]
            return {"last_hidden_state": x, "pooled_output": pooled}


class CLIPTextModelWithProjection:
    """The encoder (params ``text_model``) and the bias-free
    ``text_projection`` Dense of its pooled output (``text_embeds``)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(),
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.text_model = CLIPTextEncoder(cfg, dtype)

    def __call__(self, p, input_ids: torch.Tensor):
        out = self.text_model(sub(p, "text_model"), input_ids)
        proj = dense(sub(p, "text_projection"), out["pooled_output"], self.cfg.projection_dim,
                     self.dtype, use_bias=False)
        return {**out, "text_embeds": proj}


def port_clip_text_state_dict(sd, num_layers: int = 12) -> Dict:
    """HF CLIPTextModel state dict (``text_model.*``) -> flat {path: leaf}
    of the encoder's tree; the I64 ``position_ids`` buffer is dropped."""
    layer = "(" + "|".join(str(i) for i in range(num_layers)) + ")"
    m = KeyMapper()
    m.rule(r"text_model\.embeddings\.token_embedding\.weight", "token_embedding.embedding")
    m.rule(r"text_model\.embeddings\.position_embedding\.weight", "position_embedding")
    m.rule(r"text_model\.embeddings\.position_ids", None)
    m.norm(r"text_model\.final_layer_norm", "final_layer_norm")
    p, q = rf"text_model\.encoder\.layers\.{layer}", r"layers_\1"
    m.norm(p + r"\.(layer_norm[12])", q + r".\2")
    m.module(p + r"\.self_attn\.([qkv]_proj|out_proj)", q + r".self_attn.\2")
    m.module(p + r"\.mlp\.(fc[12])", q + r".\2")
    return m.apply(sd)

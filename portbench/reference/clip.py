"""Plain PyTorch mirror of Hugging Face's CLIPTextModel (the
clip-vit-large-patch14 text tower that SD1.5 conditions on).

Pre-LayerNorm encoder layers with quick-GELU MLPs and a causal mask, a
final LayerNorm; the pipeline reads ``last_hidden_state``. Attribute names
give ``state_dict()`` the ``text_model.*`` keys of the public checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

CLIP_L_TEXT = dict(vocab_size=49408, hidden_size=768, num_layers=12, num_heads=12,
                   max_positions=77, intermediate_size=3072, layer_norm_eps=1e-5)


class _Attention(nn.Module):
    def __init__(self, c, heads):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, mask):
        b, n, c = x.shape
        h = self.heads
        q, k, v = (p(x).view(b, n, h, c // h).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        attn = torch.softmax(q @ k.transpose(-1, -2) * (c // h) ** -0.5 + mask, dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class _MLP(nn.Module):
    def __init__(self, c, inner):
        super().__init__()
        self.fc1 = nn.Linear(c, inner)
        self.fc2 = nn.Linear(inner, c)

    def forward(self, x):
        x = self.fc1(x)
        return self.fc2(x * torch.sigmoid(1.702 * x))


class _Layer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = cfg["hidden_size"]
        self.self_attn = _Attention(c, cfg["num_heads"])
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg["layer_norm_eps"])
        self.mlp = _MLP(c, cfg["intermediate_size"])
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg["layer_norm_eps"])

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = nn.Embedding(cfg["max_positions"], cfg["hidden_size"])


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg["num_layers"])])


class _TextModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])


class CLIPTextModel(nn.Module):
    def __init__(self, cfg=None):
        super().__init__()
        self.cfg = {**CLIP_L_TEXT, **(cfg or {})}
        self.text_model = _TextModel(self.cfg)

    def forward(self, ids):
        """(B, n) ids -> last_hidden_state (B, n, C)."""
        tm = self.text_model
        n = ids.shape[1]
        pos = torch.arange(n, device=ids.device)
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)[None]
        mask = torch.full((n, n), float("-inf"), device=ids.device, dtype=x.dtype).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return F.layer_norm(x, (x.shape[-1],), tm.final_layer_norm.weight,
                            tm.final_layer_norm.bias, tm.final_layer_norm.eps)

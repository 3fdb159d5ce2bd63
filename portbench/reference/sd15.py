"""Plain PyTorch mirrors of diffusers' SD1.5 UNet2DConditionModel,
ControlNetModel and AutoencoderKL, the benchmark's reference for the
denoiser, the ControlNet trunks and the VAE.

A frozen copy of the repository's test mirror (written from the diffusers
architecture, not from the port), kept here so that a change to the
program or its tests cannot move the yardstick. Module attribute names
give ``state_dict()`` the diffusers key paths, which is how the benchmark
lays out the weights it makes. Every operation is a plain torch call: no
kernel, cache or fused path, fp32 when the weights are fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


# ------------------------------------------------------------ primitives
def get_timestep_embedding(timesteps, dim, flip_sin_to_cos=True, shift=0.0,
                           max_period=10000):
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb_dim=None, eps=1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """diffusers Attention: bias-free to_q/k/v, to_out = [Linear, Dropout]."""

    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, n, c = x.shape
        h = self.heads
        q = self.to_q(x).view(b, n, h, c // h).transpose(1, 2)
        k = self.to_k(ctx).view(b, ctx.shape[1], h, c // h).transpose(1, 2)
        v = self.to_v(ctx).view(b, ctx.shape[1], h, c // h).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) * (c // h) ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, ctx_dim, heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        x = x + self.ff(self.norm3(x))
        return x


class Transformer2DModel(nn.Module):
    """SD1.5 layout: use_linear_projection=False (1x1 conv projections)."""

    def __init__(self, dim, ctx_dim, heads, depth=1):
        super().__init__()
        self.norm = nn.GroupNorm(32, dim, eps=1e-6)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, ctx_dim, heads) for _ in range(depth)]
        )
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        res = x
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + res


class Downsample2D(nn.Module):
    def __init__(self, ch, asymmetric=False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x):
        if self.asymmetric:  # diffusers VAE encoder: pad (0,1,0,1)
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


# ------------------------------------------------------------------ UNet
class _DownBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim, layers, heads, ctx_dim,
                 with_attn, add_down):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, temb_dim)
             for j in range(layers)]
        )
        if with_attn:
            self.attentions = nn.ModuleList(
                [Transformer2DModel(cout, ctx_dim, heads) for _ in range(layers)]
            )
        if add_down:
            self.downsamplers = nn.ModuleList([Downsample2D(cout)])

    def forward(self, x, temb, ctx):
        skips = []
        for j, res in enumerate(self.resnets):
            x = res(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[j](x, ctx)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class _MidBlock(nn.Module):
    def __init__(self, ch, temb_dim, heads, ctx_dim):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim), ResnetBlock2D(ch, ch, temb_dim)]
        )
        self.attentions = nn.ModuleList([Transformer2DModel(ch, ctx_dim, heads)])

    def forward(self, x, temb, ctx):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, ctx)
        return self.resnets[1](x, temb)


class _UpBlock(nn.Module):
    def __init__(self, cout, prev_ch, skip_chs, temb_dim, heads, ctx_dim,
                 with_attn, add_up):
        super().__init__()
        layers = len(skip_chs)
        self.resnets = nn.ModuleList(
            [ResnetBlock2D((prev_ch if j == 0 else cout) + skip_chs[j], cout,
                           temb_dim)
             for j in range(layers)]
        )
        if with_attn:
            self.attentions = nn.ModuleList(
                [Transformer2DModel(cout, ctx_dim, heads) for _ in range(layers)]
            )
        if add_up:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x, skips, temb, ctx):
        for j, res in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=1)
            x = res(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[j](x, ctx)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _TrunkMixin(nn.Module):
    """conv_in + time embedding + down blocks + mid — shared by UNet and
    ControlNet (diffusers duplicates this structurally too)."""

    def _build_trunk(self, cfg):
        chs = cfg["block_out_channels"]
        layers = cfg["layers_per_block"]
        heads = cfg["num_heads"]
        ctx = cfg["cross_attention_dim"]
        temb_dim = chs[0] * 4
        self.conv_in = nn.Conv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim)
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chs):
            cin = chs[max(i - 1, 0)]
            self.down_blocks.append(
                _DownBlock(cin, ch, temb_dim, layers, heads, ctx,
                           with_attn=i < len(chs) - 1,
                           add_down=i < len(chs) - 1)
            )
        self.mid_block = _MidBlock(chs[-1], temb_dim, heads, ctx)
        self._chs, self._layers, self._temb_dim = chs, layers, temb_dim

    def _trunk(self, sample, t, ctx, cond_embedding=None):
        if t.ndim == 0:
            t = t.expand(sample.shape[0])
        temb = self.time_embedding(
            get_timestep_embedding(t, self._chs[0])
        )
        x = self.conv_in(sample)
        if cond_embedding is not None:
            x = x + cond_embedding
        skips = [x]
        for blk in self.down_blocks:
            x, s = blk(x, temb, ctx)
            skips += s
        x = self.mid_block(x, temb, ctx)
        return x, skips, temb


SD15_CFG = dict(in_channels=4, out_channels=4,
                block_out_channels=(320, 640, 1280, 1280),
                layers_per_block=2, cross_attention_dim=768, num_heads=8)


class UNet2DConditionModel(_TrunkMixin):
    def __init__(self, cfg=None):
        super().__init__()
        cfg = {**SD15_CFG, **(cfg or {})}
        self._build_trunk(cfg)
        chs, layers = self._chs, self._layers
        heads, ctx = cfg["num_heads"], cfg["cross_attention_dim"]
        rev = list(reversed(chs))
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(rev):
            prev_ch = rev[max(i - 1, 0)]
            # skip channels consumed by this block, in pop order
            down_i = len(chs) - 1 - i
            skip_top = [chs[down_i]] * layers + [
                chs[max(down_i - 1, 0)] if down_i > 0 else chs[0]
            ]
            self.up_blocks.append(
                _UpBlock(ch, prev_ch, skip_top, self._temb_dim, heads, ctx,
                         with_attn=i > 0, add_up=i < len(rev) - 1)
            )
        self.conv_norm_out = nn.GroupNorm(32, chs[0], eps=1e-5)
        self.conv_out = nn.Conv2d(chs[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, t, ctx, down_residuals=None, mid_residual=None):
        x, skips, temb = self._trunk(sample, t, ctx)
        if down_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_residuals)]
        if mid_residual is not None:
            x = x + mid_residual
        for blk in self.up_blocks:
            n = len(blk.resnets)
            blk_skips, skips = skips[-n:], skips[:-n]
            x = blk(x, blk_skips, temb, ctx)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class ControlNetConditioningEmbedding(nn.Module):
    def __init__(self, cond_channels=3, channels=(16, 32, 96, 256), out_ch=320):
        super().__init__()
        self.conv_in = nn.Conv2d(cond_channels, channels[0], 3, padding=1)
        blocks = []
        for i in range(len(channels) - 1):
            blocks.append(nn.Conv2d(channels[i], channels[i], 3, padding=1))
            blocks.append(nn.Conv2d(channels[i], channels[i + 1], 3, padding=1,
                                    stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(channels[-1], out_ch, 3, padding=1)

    def forward(self, x):
        x = F.silu(self.conv_in(x))
        for b in self.blocks:
            x = F.silu(b(x))
        return self.conv_out(x)


class ControlNetModel(_TrunkMixin):
    def __init__(self, cfg=None, cond_channels=(16, 32, 96, 256)):
        super().__init__()
        cfg = {**SD15_CFG, **(cfg or {})}
        self._build_trunk(cfg)
        chs, layers = self._chs, self._layers
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            3, cond_channels, chs[0]
        )
        skip_chs = [chs[0]]
        for i, ch in enumerate(chs):
            skip_chs += [ch] * layers
            if i < len(chs) - 1:
                skip_chs.append(ch)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in skip_chs]
        )
        self.controlnet_mid_block = nn.Conv2d(chs[-1], chs[-1], 1)

    def forward(self, sample, t, ctx, cond, scale=1.0, cond_is_embedding=False):
        emb = cond if cond_is_embedding else self.controlnet_cond_embedding(cond)
        x, skips, _ = self._trunk(sample, t, ctx, cond_embedding=emb)
        down = [zb(s) * scale for zb, s in zip(self.controlnet_down_blocks, skips)]
        mid = self.controlnet_mid_block(x) * scale
        return down, mid


# ------------------------------------------------------------------- VAE
class VaeAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c), nn.Identity()])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        attn = torch.softmax(q @ k.transpose(1, 2) * c ** -0.5, dim=-1)
        out = self.to_out[0](attn @ v)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class _VaeMid(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, None, eps=1e-6), ResnetBlock2D(ch, ch, None, eps=1e-6)]
        )
        self.attentions = nn.ModuleList([VaeAttention(ch)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _VaeDown(nn.Module):
    def __init__(self, cin, cout, add_down, layers=2):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, None, eps=1e-6)
             for j in range(layers)]
        )
        if add_down:
            self.downsamplers = nn.ModuleList([Downsample2D(cout, asymmetric=True)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class _VaeUp(nn.Module):
    def __init__(self, cin, cout, add_up, layers=3):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, None, eps=1e-6)
             for j in range(layers)]
        )
        if add_up:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class VaeEncoder(nn.Module):
    def __init__(self, chs=(128, 256, 512, 512), zc=4, layers=2):
        super().__init__()
        self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chs):
            self.down_blocks.append(
                _VaeDown(chs[max(i - 1, 0)], ch, add_down=i < len(chs) - 1,
                         layers=layers)
            )
        self.mid_block = _VaeMid(chs[-1])
        self.conv_norm_out = nn.GroupNorm(32, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * zc, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for b in self.down_blocks:
            x = b(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VaeDecoder(nn.Module):
    def __init__(self, chs=(128, 256, 512, 512), zc=4, layers=3):
        super().__init__()
        rev = list(reversed(chs))
        self.conv_in = nn.Conv2d(zc, rev[0], 3, padding=1)
        self.mid_block = _VaeMid(rev[0])
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(rev):
            self.up_blocks.append(
                _VaeUp(rev[max(i - 1, 0)], ch, add_up=i < len(rev) - 1,
                       layers=layers)
            )
        self.conv_norm_out = nn.GroupNorm(32, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        x = self.conv_in(z)
        x = self.mid_block(x)
        for b in self.up_blocks:
            x = b(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, chs=(128, 256, 512, 512), zc=4, layers=2):
        super().__init__()
        self.encoder = VaeEncoder(chs, zc, layers)
        self.decoder = VaeDecoder(chs, zc, layers + 1)
        self.quant_conv = nn.Conv2d(2 * zc, 2 * zc, 1)
        self.post_quant_conv = nn.Conv2d(zc, zc, 1)

    def encode_moments(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

"""AutoencoderKL (the SD1.5 KL-f8 VAE).

Counterpart of edgestyle_tpu/models/vae.py: 4 encoder stages of two ResNet
blocks and a stride-2 downsample with asymmetric (0,1) padding, a mid block
with single-head attention, a decoder with three ResNet blocks per stage
and nearest-2x upsampling. GroupNorm eps is 1e-6 throughout.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core import spans
from edgestyle_tpu_torch.core.params import sub
from edgestyle_tpu_torch.core.porting import KeyMapper
from edgestyle_tpu_torch.models.layers import (
    conv,
    downsample,
    group_norm_block,
    resnet_block,
    upsample,
    vae_attention,
)

SD_VAE_SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = SD_VAE_SCALING_FACTOR
    sample_size: int = 512


def _mid(p, x, ch, dtype):
    x = resnet_block(sub(p, "resnet_0"), x, None, ch, dtype, eps=1e-6, use_time_emb=False)
    x = vae_attention(sub(p, "attn"), x, dtype)
    return resnet_block(sub(p, "resnet_1"), x, None, ch, dtype, eps=1e-6, use_time_emb=False)


class AutoencoderKL:
    def __init__(self, cfg: VAEConfig = VAEConfig(), dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype

    def _encoder(self, p, x):
        cfg, dt = self.cfg, self.dtype
        chs = cfg.block_out_channels
        h = conv(sub(p, "conv_in"), x, chs[0], 3, dt)
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                h = resnet_block(sub(p, f"down_{i}_resnet_{j}"), h, None, ch, dt, eps=1e-6,
                                 use_time_emb=False)
            if i < len(chs) - 1:
                h = downsample(sub(p, f"down_{i}_downsample"), h, ch, dt, asymmetric_pad=True)
        h = _mid(sub(p, "mid"), h, chs[-1], dt)
        h = group_norm_block(sub(p, "conv_norm_out"), h, 32, 1e-6, act=F.silu)
        return conv(sub(p, "conv_out"), h, 2 * cfg.latent_channels, 3, dt)

    def _decoder(self, p, z):
        cfg, dt = self.cfg, self.dtype
        rev = tuple(reversed(cfg.block_out_channels))
        h = conv(sub(p, "conv_in"), z, rev[0], 3, dt)
        h = _mid(sub(p, "mid"), h, rev[0], dt)
        for i, ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                h = resnet_block(sub(p, f"up_{i}_resnet_{j}"), h, None, ch, dt, eps=1e-6,
                                 use_time_emb=False)
            if i < len(rev) - 1:
                h = upsample(sub(p, f"up_{i}_upsample"), h, ch, dt)
        h = group_norm_block(sub(p, "conv_norm_out"), h, 32, 1e-6, act=F.silu)
        return conv(sub(p, "conv_out"), h, cfg.in_channels, 3, dt)

    def encode_moments(self, p, x):
        """x: (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 4, H/8, W/8)."""
        with spans.span(spans.VAE_ENCODE):
            moments = conv(sub(p, "quant_conv"), self._encoder(sub(p, "encoder"), x),
                           2 * self.cfg.latent_channels, 1, self.dtype, padding=0)
            mean, logvar = moments.chunk(2, dim=1)
            return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, p, x, generator: Optional[torch.Generator] = None):
        """Posterior sample, or its mode when no generator is given.
        Unscaled: callers multiply by cfg.scaling_factor."""
        mean, logvar = self.encode_moments(p, x)
        if generator is None:
            return mean
        std = torch.exp(0.5 * logvar)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
        return mean + std * noise

    def decode(self, p, z):
        """z: (B, 4, h, w) unscaled latents -> image (B, 3, 8h, 8w)."""
        with spans.span(spans.VAE_DECODE):
            z = conv(sub(p, "post_quant_conv"), z, self.cfg.latent_channels, 1, self.dtype,
                     padding=0)
            return self._decoder(sub(p, "decoder"), z)

    def __call__(self, p, x, generator: Optional[torch.Generator] = None):
        return self.decode(p, self.encode(p, x, generator))


def _map_resnet(m: KeyMapper, tp: str, fp: str) -> KeyMapper:
    g = re.compile(tp).groups
    m.norm(tp + r"\.(norm[12])", fp + rf".\g<{g + 1}>")
    m.module(tp + r"\.(conv1|conv2|conv_shortcut)", fp + rf".\g<{g + 1}>")
    return m


def port_vae_state_dict(sd) -> Dict:
    """diffusers AutoencoderKL state dict (stabilityai/sd-vae-ft-mse) ->
    flat {path: leaf} of the port's tree, renamed only (torch's layouts are
    the port's)."""
    m = KeyMapper()
    m.module(r"(quant_conv|post_quant_conv)", r"\1")
    m.module(r"(encoder|decoder)\.(conv_in|conv_out)", r"\1.\2")
    m.norm(r"(encoder|decoder)\.conv_norm_out", r"\1.conv_norm_out")
    _map_resnet(m, r"(encoder|decoder)\.mid_block\.resnets\.([01])", r"\1.mid.resnet_\2")
    mp, fp = r"(encoder|decoder)\.mid_block\.attentions\.0", r"\1.mid.attn"
    m.norm(mp + r"\.group_norm", fp + ".group_norm")
    m.module(mp + r"\.(to_[qkv])", fp + r".\2")
    m.module(mp + r"\.to_out\.0", fp + ".to_out")
    _map_resnet(m, r"encoder\.down_blocks\.([0-3])\.resnets\.([01])", r"encoder.down_\1_resnet_\2")
    m.module(r"encoder\.down_blocks\.([0-3])\.downsamplers\.0\.conv",
             r"encoder.down_\1_downsample.conv")
    _map_resnet(m, r"decoder\.up_blocks\.([0-3])\.resnets\.([0-2])", r"decoder.up_\1_resnet_\2")
    m.module(r"decoder\.up_blocks\.([0-3])\.upsamplers\.0\.conv", r"decoder.up_\1_upsample.conv")
    return m.apply(sd)

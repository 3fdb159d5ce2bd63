"""Parity of the PyTorch port's models (edgestyle_tpu_torch.models) with
the JAX package's, on the CPU in fp32 at the TINY test configs.

Each test initialises the JAX module, perturbs every param with seeded
noise (so zero-init heads and unit norms are exercised too), converts the
tree with ``from_jax_params`` and runs both sides on the same seeded numpy
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.models import layers as jl
from edgestyle_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from edgestyle_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from edgestyle_tpu.models.multicontrolnet import EdgeStyleFusion as JFusion
from edgestyle_tpu.models.multicontrolnet import interleave_residuals as j_interleave
from edgestyle_tpu.models.unet import SD15UNet as JUNet
from edgestyle_tpu.models.unet import init_lora_params as j_init_lora
from edgestyle_tpu.models.unet import merge_lora as j_merge_lora
from edgestyle_tpu.models.unet import split_trunk_params as j_split_trunk
from edgestyle_tpu.models.vae import AutoencoderKL as JVAE
from edgestyle_tpu.models.vae import VAEConfig as JVAEConfig
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.porting import from_jax_params
from edgestyle_tpu_torch.models import layers
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from edgestyle_tpu_torch.models.multicontrolnet import edgestyle_fusion, interleave_residuals
from edgestyle_tpu_torch.models.unet import SD15UNet, UNetConfig, merge_lora
from edgestyle_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tests.test_torch_ops import nchw, nhwc
from tests.test_unet import TINY as J_TINY
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-4  # fp32 on both sides

TINY = UNetConfig(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=24,
                  num_heads=2, cond_embedding_channels=(8, 16))
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1, sample_size=32)
TINY_CLIP = dict(vocab_size=100, hidden_size=24, num_layers=2, num_heads=2, max_positions=7,
                 intermediate_size=32)


def perturb(tree, rng, s=0.05):
    """numpy copy of a JAX param tree with N(0, s) noise on every leaf."""
    return jax.tree.map(
        lambda a: (np.asarray(a) + s * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


def port(tree):
    return from_jax_params(tree, device="cpu", dtype=torch.float32)


def close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out, np.asarray(ref), atol=atol, rtol=1e-4)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_resnet_block_matches_jax(rng):
    x, temb = randn(rng, 2, 6, 6, 32), randn(rng, 2, 16)
    mod = jl.ResnetBlock2D(64)
    params = perturb(mod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(temb))["params"],
                     rng)
    ref = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb))
    out = layers.resnet_block(port(params), nchw(x), torch.from_numpy(temb), 64, torch.float32)
    close(nhwc(out), ref)


def test_transformer_2d_matches_jax(rng):
    x, ctx = randn(rng, 2, 4, 4, 32), randn(rng, 2, 7, 24)
    mod = jl.Transformer2D(num_heads=2, attn_impl="xla")
    params = perturb(mod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx))["params"],
                     rng)
    ref = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    out = layers.transformer_2d(port(params), nchw(x), torch.from_numpy(ctx), 2, torch.float32)
    close(nhwc(out), ref)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 10, 999], np.int64)
    ref = jl.timestep_embedding(jnp.asarray(t), 32)
    close(layers.timestep_embedding(torch.from_numpy(t), 32).numpy(), ref, atol=1e-5)


@pytest.fixture(scope="module")
def unet_pair():
    rng = np.random.default_rng(1)
    j = JUNet(J_TINY, attn_impl="xla")
    x, t, ctx = jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 24))
    params = perturb(j.init(jax.random.key(0), x, t, ctx)["params"], rng)
    return j, params


def test_unet_with_residuals_matches_jax(rng, unet_pair):
    j, params = unet_pair
    x, ctx = randn(rng, 2, 16, 16, 4), randn(rng, 2, 7, 24)
    t = np.array([10, 500], np.int64)
    skips = [(16, 32)] * 2 + [(8, 32), (8, 64), (8, 64)]
    down = [randn(rng, 2, s, s, c) * 0.1 for s, c in skips]
    mid = randn(rng, 2, 8, 8, 64) * 0.1
    ref = j.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                  down_block_additional_residuals=[jnp.asarray(d) for d in down],
                  mid_block_additional_residual=jnp.asarray(mid))
    out = SD15UNet(TINY)(port(params), nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         down_block_additional_residuals=[nchw(d) for d in down],
                         mid_block_additional_residual=nchw(mid))
    assert out.dtype == torch.float32
    close(nhwc(out), ref)


@pytest.mark.parametrize("guess_mode", [False, True])
def test_controlnet_forward_and_embed_cond_match_jax(rng, guess_mode):
    j = JUNet(J_TINY, controlnet_mode=True, attn_impl="xla")
    x, t, ctx = jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 24))
    emb0, img0 = jnp.zeros((1, 16, 16, 32)), jnp.zeros((1, 32, 32, 3))
    params = {**j.init(jax.random.key(1), x, t, ctx, emb0, method="controlnet_forward")["params"],
              **j.init(jax.random.key(2), img0, method="embed_cond")["params"]}
    params = perturb(params, rng)
    x, ctx = randn(rng, 2, 16, 16, 4), randn(rng, 2, 7, 24)
    img = randn(rng, 2, 32, 32, 3)  # one stride-2 stage at TINY
    t = np.array([3, 700], np.int64)
    jemb = j.apply({"params": params}, jnp.asarray(img), method="embed_cond")
    pt = port(params)
    cn = SD15UNet(TINY, controlnet_mode=True)
    emb = cn.embed_cond(pt, nchw(img))
    close(nhwc(emb), jemb)
    jd, jm = j.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), jemb,
                     0.7, guess_mode, method="controlnet_forward")
    d, m = cn.controlnet_forward(pt, nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), emb,
                                 0.7, guess_mode)
    assert len(d) == len(jd) == len(cn.skip_channels())
    for a, b in zip(d, jd):
        close(nhwc(a), b)
    close(nhwc(m), jm)


def test_vae_encode_decode_match_jax(rng):
    j = JVAE(JVAEConfig(**TINY_VAE))
    x = randn(rng, 2, 32, 32, 3)
    params = perturb(j.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"], rng)
    vae = AutoencoderKL(VAEConfig(**TINY_VAE))
    pt = port(params)
    jmean, jlogvar = j.apply({"params": params}, jnp.asarray(x), method=j.encode_moments)
    mean, logvar = vae.encode_moments(pt, nchw(x))
    close(nhwc(mean), jmean)
    close(nhwc(logvar), jlogvar)
    close(nhwc(vae.encode(pt, nchw(x))), jmean)  # no generator: the posterior mode
    z = randn(rng, 2, 16, 16, 4)
    jimg = j.apply({"params": params}, jnp.asarray(z), method=j.decode)
    close(nhwc(vae.decode(pt, nchw(z))), jimg)


def test_clip_text_matches_jax(rng):
    j = JCLIP(JCLIPConfig(**TINY_CLIP))
    ids = rng.integers(1, 99, size=(3, 7))
    params = perturb(j.init(jax.random.key(0), jnp.zeros((1, 7), jnp.int32))["params"], rng)
    ref = j.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    out = CLIPTextEncoder(CLIPTextConfig(**TINY_CLIP))(port(params), torch.from_numpy(ids))
    close(out["last_hidden_state"].numpy(), ref["last_hidden_state"])
    close(out["pooled_output"].numpy(), ref["pooled_output"])


def test_interleave_pairing_matches_jax(rng):
    ts = [randn(rng, 2, 3, 3, 5) for _ in range(6)]
    ref = j_interleave([jnp.asarray(t) for t in ts])
    out = interleave_residuals([nchw(t) for t in ts])
    np.testing.assert_array_equal(nhwc(out), np.asarray(ref))


@pytest.mark.parametrize("num_nets", [6, 4])
def test_fusion_blocks_match_jax(rng, num_nets):
    """The 13 fusion blocks, including the grouped 1x1 channel pairing
    (HWIO (1,1,in_per_group,groups) -> torch grouped (groups,in_per_group,1,1))."""
    down_ch, mid_ch = (32, 32, 64), 64
    sizes = ((8, 8), (4, 4), (4, 4))
    j = JFusion(num_nets=num_nets, down_channels=down_ch, mid_channels=mid_ch)
    downs = [[randn(rng, 2, s[0], s[1], c) for s, c in zip(sizes, down_ch)]
             for _ in range(num_nets)]
    mids = [randn(rng, 2, 4, 4, mid_ch) for _ in range(num_nets)]
    jd = [[jnp.asarray(a) for a in d] for d in downs]
    jm = [jnp.asarray(m) for m in mids]
    params = perturb(j.init(jax.random.key(0), jd, jm)["params"], rng, s=0.2)
    ref_d, ref_m = j.apply({"params": params}, jd, jm)
    out_d, out_m = edgestyle_fusion(port(params), [[nchw(a) for a in d] for d in downs],
                                    [nchw(m) for m in mids], down_ch, mid_ch, torch.float32)
    for a, b in zip(out_d, ref_d):
        close(nhwc(a), b)
    close(nhwc(out_m), ref_m)


def test_merge_lora_matches_jax(unet_pair, rng):
    """JAX adapters are down (in, r), up (r, out); the port's, in its
    (out, in) layout, are their transposes."""
    _, params = unet_pair
    trunk = j_split_trunk(params)
    lora = j_init_lora(jax.random.key(3), trunk, rank=4)
    lora = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape), lora)
    ref = flatten(port(j_merge_lora(trunk, lora, 0.5)))
    lora_t = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32).T.copy()), lora)
    out = flatten(merge_lora(port(trunk), lora_t, 0.5))
    assert out.keys() == ref.keys()
    for path, a in out.items():
        np.testing.assert_allclose(a.numpy(), ref[path].numpy(), atol=1e-5, err_msg=str(path))

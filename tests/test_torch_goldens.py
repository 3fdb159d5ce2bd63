"""The PyTorch port against the committed mirror goldens
(tests/goldens/mirror_v1.npz), on the CPU in fp32.

The goldens were captured from torch mirrors of the diffusers modules at
fixed seeds. The same synthetic diffusers-keyed weights flow through the
JAX package's port mappers (numpy only) into a Flax-layout tree, then
through ``from_jax_params`` into the port, which must reproduce the
committed tensors within the tolerances of tests/test_goldens_committed.py
(relative to the golden's largest magnitude).
"""

import numpy as np
import pytest
import torch

from edgestyle_tpu.core import porting as jporting
from edgestyle_tpu_torch.core.porting import from_jax_params
from edgestyle_tpu_torch.models.multicontrolnet import fusion_block
from edgestyle_tpu_torch.models.unet import SD15UNet, UNetConfig
from edgestyle_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tests import golden_mirror as gm
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(
    not __import__("os").path.exists(gm.GOLDENS_NPZ),
    reason="committed goldens missing — run scripts/capture_mirror_goldens.py",
)


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(gm.GOLDENS_NPZ))


@pytest.fixture(scope="module")
def shapes():
    return gm.load_shapes()


def port(flat):
    return from_jax_params(jporting.unflatten(flat), device="cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def scaled_close(got, want, atol, msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err < atol, f"{msg}: scaled max diff {err:.2e} (tol {atol})"


@torch.no_grad()
def test_unet_mid_matches_golden(goldens, shapes):
    from edgestyle_tpu.models.unet import port_unet_state_dict

    p = port(port_unet_state_dict(gm.synth_state_dict(shapes["unet_mid"])))
    unet = SD15UNet(UNetConfig(**gm.UNET_MID))
    lat, ts, ctx = gm.unet_inputs()
    out = unet(p, t(lat), t(ts), t(ctx))
    scaled_close(out, goldens["unet_mid.out"], 1e-4, "unet")
    down, mid = gm.unet_residual_inputs(unet.skip_channels())
    out = unet(p, t(lat), t(ts), t(ctx), down_block_additional_residuals=[t(d) for d in down],
               mid_block_additional_residual=t(mid))
    scaled_close(out, goldens["unet_mid.out_res"], 1e-4, "unet+res")


@torch.no_grad()
def test_controlnet_mid_matches_golden(goldens, shapes):
    from edgestyle_tpu.models.unet import port_controlnet_state_dict

    p = port(port_controlnet_state_dict(gm.synth_state_dict(shapes["cn_mid"])))
    cn = SD15UNet(UNetConfig(**gm.UNET_MID, cond_embedding_channels=gm.CN_COND_CH),
                  controlnet_mode=True)
    lat, ts, ctx = gm.unet_inputs()
    emb = cn.embed_cond(p, t(gm.controlnet_inputs()))
    down, mid = cn.controlnet_forward(p, t(lat), t(ts), t(ctx), emb, conditioning_scale=0.7)
    for i, d in enumerate(down):
        scaled_close(d, goldens[f"cn_mid.down{i}"], 1e-4, f"down{i}")
    scaled_close(mid, goldens["cn_mid.mid"], 1e-4, "mid")


@torch.no_grad()
def test_vae_mid_matches_golden(goldens, shapes):
    from edgestyle_tpu.models.vae import port_vae_state_dict

    p = port(port_vae_state_dict(gm.synth_state_dict(shapes["vae_mid"])))
    vae = AutoencoderKL(VAEConfig(block_out_channels=gm.VAE_MID["chs"],
                                  layers_per_block=gm.VAE_MID["layers"],
                                  sample_size=gm.VAE_MID["px"]))
    mean, logvar = vae.encode_moments(p, t(gm.vae_inputs()))
    moments = goldens["vae_mid.moments"]
    zc = moments.shape[1] // 2
    scaled_close(mean, moments[:, :zc], 5e-4, "vae mean")
    scaled_close(logvar, np.clip(moments[:, zc:], -30.0, 20.0), 5e-4, "vae logvar")
    scaled_close(vae.decode(p, t(moments[:, :zc])), goldens["vae_mid.decode"], 5e-4,
                 "vae decode")


@torch.no_grad()
def test_fusion_block_matches_golden(goldens, shapes):
    """The torch mirror's fusion block (grouped Conv2d, LayerNorm([C,H,W]))
    against the port's, whose grouped 1x1 weights take the torch layout
    after the JAX mapper and from_jax_params: the channel pairing holds."""
    sd = gm.synth_state_dict(shapes["fusion"])
    m = jporting.KeyMapper()
    for conv in ("first_conv", "second_conv", "third_conv"):
        m.conv(conv, conv)
    for ln in ("first_normalization", "second_normalization"):
        m.rule(ln + r"\.weight", ln + ".scale", lambda w: np.transpose(w, (1, 2, 0)))
        m.rule(ln + r"\.bias", ln + ".bias", lambda w: np.transpose(w, (1, 2, 0)))
    p = port(m.apply(sd))
    x = t(gm.fusion_inputs())  # (B, C*N, H, W)
    out = fusion_block(p, x.permute(0, 2, 3, 1), gm.FUSION["c"], gm.FUSION["n"], torch.float32)
    scaled_close(out.permute(0, 3, 1, 2), goldens["fusion.out"], 1e-5, "fusion")


def test_prodigy_matches_golden_trajectory(goldens):
    """The port's Prodigy (the trainer's settings: lr 1, weight decay 1e-4,
    safeguard warmup and bias correction) on the ill-conditioned two-tensor
    problem: the 10 parameter snapshots and the d trace of the committed
    golden, at tests/test_goldens_committed.py's tolerances."""
    from edgestyle_tpu_torch.training.optim import apply_updates
    from edgestyle_tpu_torch.training.prodigy import Prodigy, get_d

    params, targets, scales = gm.prodigy_problem()
    opt = Prodigy(learning_rate=1.0, weight_decay=1e-4, safeguard_warmup=True,
                  use_bias_correction=True)
    ps = {f"p{j}": t(p) for j, p in enumerate(params)}
    state = opt.init(ps)
    d_got = []
    for it in range(gm.PRODIGY_STEPS):
        grads = {f"p{j}": s * (ps[f"p{j}"] - t(tg))
                 for j, (tg, s) in enumerate(zip(targets, scales))}
        updates, state = opt.update(grads, state, ps)
        ps = apply_updates(ps, updates)
        if it in gm.PRODIGY_CHECKPOINTS:
            d_got.append(float(get_d(state)))
            for j in range(len(params)):
                np.testing.assert_allclose(ps[f"p{j}"].numpy(), goldens[f"prodigy.step{it}.p{j}"],
                                           rtol=2e-4, atol=2e-5, err_msg=f"step {it} p{j}")
    np.testing.assert_allclose(d_got, goldens["prodigy.d_trace"], rtol=1e-3)

"""int8 serving's card route (marked ``gpu``; skipped without a card): the
im2col GEMM and the Dense on ``torch._int_mm`` against the fp64 plain
route on the CPU, and a pre-quantised ResNet conv through
``norm_act_conv3x3`` on the card against the same op on the CPU. The file
imports nothing of JAX or of the JAX package, so it runs where only the
port's dependencies are installed.

The quantisation itself is bit-equal on the card and the CPU (true
divisions and round half to even on both), so the int8 values, the int32
accumulators and the dequantised fp32 outputs are all held bit for bit.
"""

import pytest
import torch
import torch.nn.functional as F

from edgestyle_tpu_torch import kernels
from edgestyle_tpu_torch.ops import fused_conv, quant


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 route runs cuBLASLt's int8 GEMM")
    return torch.device("cuda")


def _conv_case(gen, b, cin, h, w, cout, k):
    x = torch.randn((b, cin, h, w), generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    kern = (torch.randn((cout, cin, k, k), generator=gen) / (k * k * cin) ** 0.5)
    kern = kern.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return x, kern, torch.randn((cout,), generator=gen).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("b,cin,h,w,cout,k,stride,padding", [
    (2, 320, 32, 32, 320, 3, 1, 1), (2, 640, 16, 16, 320, 3, 1, 1),
    (2, 320, 32, 32, 320, 3, 2, 1), (2, 128, 32, 32, 128, 3, 2, (0, 1, 0, 1)),
    (2, 640, 16, 16, 1280, 1, 1, 0),
])
def test_int8_conv_on_the_card_equals_the_plain_route(cuda, b, cin, h, w, cout, k, stride,
                                                      padding):
    gen = torch.Generator().manual_seed(0)
    x, kern, bias = _conv_case(gen, b, cin, h, w, cout, k)
    outs, accs = [], []
    for dev in (cuda, torch.device("cpu")):
        qk = quant.quantize_params({"c": {"kernel": kern.to(dev)}})["c"]["kernel"]
        qx, sx = quant.quantize_activation(x.to(dev))
        accs.append((qx.cpu(), qk.q.cpu(), qk.s.cpu(), sx.cpu(),
                     quant.conv_int32(qx, qk, stride, padding).cpu()))
        outs.append(quant.quant_conv(x.to(dev), qk, bias.to(dev), torch.bfloat16, stride,
                                     padding).float().cpu())
    for a, p in zip(accs[0], accs[1]):
        assert torch.equal(a, p)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,features", [((2, 1024, 640), 640), ((2, 77, 768), 320),
                                            ((2, 64, 1280), 5120)])
def test_int8_dense_on_the_card_equals_the_plain_route(cuda, shape, features):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    kern = (torch.randn((features, shape[-1]), generator=gen) / shape[-1] ** 0.5
            ).to(torch.bfloat16)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        qk = quant.quantize_params({"d": {"kernel": kern.to(dev)}})["d"]["kernel"]
        qx, _ = quant.quantize_activation(x.to(dev))
        outs.append((quant.dense_int32(qx, qk).cpu(),
                     quant.quant_dense(x.to(dev), qk, None, torch.bfloat16).float().cpu()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.gpu
def test_prequantised_resnet_conv_skips_the_bf16_kernels_on_the_card(cuda):
    """A QuantKernel conv through norm_act_conv3x3 on the card launches no GN
    statistics or fused conv kernel, and equals the CPU's int8 branch (the
    GroupNorm's bf16 output may round differently, so the int8 activation is
    fed from the CPU's GroupNorm)."""
    gen = torch.Generator().manual_seed(2)
    x, kern, bias = _conv_case(gen, 2, 320, 32, 32, 320, 3)
    gamma, beta = torch.randn(320, generator=gen), torch.randn(320, generator=gen)
    qk = quant.quantize_params({"c": {"kernel": kern.to(cuda)}}, "unet")["c"]["kernel"]
    before = dict(kernels.LAUNCHES)
    quant.reset_counts()
    out = fused_conv.norm_act_conv3x3(x.to(cuda), gamma.to(cuda), beta.to(cuda), qk,
                                      bias.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == before and quant.COUNTS["conv"] == 1
    h = fused_conv.group_norm(x, gamma, beta, 32, 1e-5, act=F.silu)
    qk_cpu = quant.QuantKernel(qk.q.cpu(), qk.s.cpu(), qk.key)
    ref = quant.quant_conv(h, qk_cpu, bias, torch.bfloat16, 1, 1)
    card = quant.quant_conv(h.to(cuda), qk, bias.to(cuda), torch.bfloat16, 1, 1)
    assert torch.equal(card.float().cpu(), ref.float())
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()

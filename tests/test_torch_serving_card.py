"""The serving knobs' card-side risks (marked ``gpu``; skipped without a
card): ToMe's ranking on the card against the CPU on the same bf16 metric,
and the flash forward kernel at the token counts ToMe gives the 64x64 level
(2048 at ratio 0.5, 2868 at ratio 0.3, off the kernel's 128-key tile grid)
and at a CFG-off step's 8 heads of 4096, against its plain version. The file
imports nothing of JAX or of the JAX package, so it runs where only the
port's dependencies are installed.
"""

import math

import pytest
import torch

from edgestyle_tpu_torch.ops import flash, tome


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_tome_rows_on_the_card_equal_the_cpu(cuda, ratio):
    """build_merge on a (2, 4096, 320) bf16 metric (SD1.5's 64x64 level):
    the row each token reads is equal on the card and on the CPU (the
    scores' fp64 sums leave no rounding for the two to disagree on); the
    merged bf16 values within one bf16 rounding (the scatter-mean's fp32
    sums run in another order)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    metric = torch.randn((2, 4096, 320), generator=gen, device=cuda).to(torch.bfloat16)
    r = int(ratio * 4096)
    rows, merged = [], []
    for dev in (cuda, torch.device("cpu")):
        m = metric.to(dev)
        merge, unmerge, r_eff = tome.build_merge(m, 64, 64, r)
        assert r_eff == r
        ids = torch.arange(4096 - r, dtype=torch.float32, device=dev)
        rows.append(unmerge(ids[None, :, None].expand(2, -1, 1)).cpu())
        merged.append(merge(m).float().cpu())
    assert torch.equal(rows[0], rows[1])
    torch.testing.assert_close(merged[0], merged[1], atol=2.0 ** -7, rtol=2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,n", [(16, 2048), (48, 2048), (8, 4096), (16, 4096 - int(0.3 * 4096))])
def test_flash_kernel_at_serving_shapes_matches_plain_on_card(cuda, bh, n):
    d = 40
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, bh, n, d), generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash.flash_attention_cuda(q, k, v, scale)
    ref = flash.flash_attention_reference(q, k, v, scale)
    # 2^-6 of the largest output, as tests/test_torch_ops.py's flash card test
    atol = 2.0 ** -6 * ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, flash.flash_attention_reference_lse(q, k, scale),
                               atol=1e-3, rtol=0)

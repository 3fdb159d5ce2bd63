"""Several cards' code path on one card (marked ``gpu``; skipped without
one): a one-rank NCCL group's ``generate_dp`` at MID width, bf16, against
the single-process ``__call__`` on the same inputs, bit for bit (one rank
runs the same call on every row; the all-reduce of one rank returns its
input), with the same kernel launches (every step's, and the VAE's). Two
ranks need two processes on the card: chip_smoke's ``multicard`` phase runs
them. The file imports nothing of JAX or of the JAX package.
"""

import pytest
import torch

from edgestyle_tpu_torch import kernels
from edgestyle_tpu_torch.core import mesh as M
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests.test_torch_export_card import MID_BF16, STEP_LAUNCHES

STEPS = 2


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(M.free_port()))
    dev = M.init_distributed("cuda", backend="nccl")
    yield dev
    M._destroy()


@pytest.mark.gpu
def test_one_rank_generate_dp_equals_call(cuda):
    mesh = M.make_mesh(device=cuda)
    pipe = EdgeStylePipeline(MID_BF16, device=cuda)
    params = pipe.init_params(make_generator(3, cuda))
    gen = make_generator(4, cuda)
    ids = torch.randint(1, 128, (2, 16), generator=gen, device=cuda)
    neg = torch.randint(1, 128, (2, 16), generator=gen, device=cuda)
    imgs = [torch.rand((2, 3, 256, 256), generator=gen, device=cuda) for _ in range(6)]
    launches = {}
    for which in ("call", "generate_dp"):
        kernels.reset_launches()
        if which == "call":
            ref = pipe(params, ids, neg, imgs, generator=make_generator(5, cuda),
                       num_inference_steps=STEPS)
        else:
            out = pipe.generate_dp(mesh, params, ids, neg, imgs,
                                   generator=make_generator(5, cuda), num_inference_steps=STEPS)
        torch.cuda.synchronize()
        launches[which] = dict(kernels.LAUNCHES)
    assert launches["generate_dp"] == launches["call"]
    assert launches["call"]["flash_fwd"] >= STEPS * STEP_LAUNCHES["flash_fwd"]
    assert launches["call"]["fused_gn_silu_conv3x3"] > STEPS * STEP_LAUNCHES[
        "fused_gn_silu_conv3x3"]
    assert torch.isfinite(out).all() and out.shape == (2, 3, 256, 256)
    assert torch.equal(out, ref)

"""The port's several-card paths against the JAX package's, on CPU ranks.

The port's ranks are processes joined by ``gloo``
(core/mesh.py::run_ranks, tests/torch_multicard_workers.py); the JAX
package runs on the 8 virtual CPU devices of tests/conftest.py. Each
scenario starts its ranks once (~4 s of start-up each). fp32 at the TINY
configuration; tolerances: generate_dp 1e-5 and generate_tp 2e-4, JAX's
own (tests/test_pipeline.py), the data-parallel steps 1e-5 of each leaf's
largest value against the single-process port step (which
tests/test_torch_training_parity.py holds against JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.core.mesh import MeshSpec as JMeshSpec
from edgestyle_tpu.core.mesh import make_mesh as jmake_mesh
from edgestyle_tpu.core.partitioning import shard_params_tp as jshard_params_tp
from edgestyle_tpu.core.partitioning import tp_spec_for_path as jtp_spec_for_path
from edgestyle_tpu.core.porting import flatten as jflatten
from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu_torch.apps import train as train_app
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.mesh import init_distributed, run_ranks
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.partitioning import local_shard, tp_spec_for_path
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.entry import dryrun_multichip
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.training import checkpoint
from edgestyle_tpu_torch.training.train_step import TrainConfig, local_draws, sample_draws
from tests import torch_multicard_workers as W
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_data import make_tree
from tests.test_torch_models import perturb
from tests.test_torch_ops import nchw, nhwc
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jax_tiny():
    """JAX's TINY pipeline and params in its layout: the port's own TINY
    init moved across with ``to_jax_params`` (JAX's init takes ~25 s more),
    perturbed so that the zero-init heads and convs are live."""
    params = EdgeStylePipeline(W.TINY_PIPE, device="cpu").init_params(make_generator(0, "cpu"))
    return (JPipeline(J_TINY_PIPE, attn_impl="xla"),
            perturb(to_jax_params(params), np.random.default_rng(0)))


def _request(b: int, seed: int):
    """ids, negative ids, six control images and latents, NHWC numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 99, size=(b, 7)), rng.integers(1, 99, size=(b, 7)),
            [(rng.standard_normal((b, 32, 32, 3)) * 0.5).astype(np.float32) for _ in range(6)],
            rng.standard_normal((b, 16, 16, 4)).astype(np.float32))


def _port_request(req):
    ids, neg, imgs, lat = req
    return ids, neg, [nchw(im).numpy() for im in imgs], nchw(lat).numpy()


def _jax_run(fn, req, **kw):
    ids, neg, imgs, lat = req
    return np.asarray(fn(jnp.asarray(ids, jnp.int32), jnp.asarray(neg, jnp.int32),
                         [jnp.asarray(im) for im in imgs], latents=jnp.asarray(lat),
                         num_inference_steps=2, **kw))


def _single(params, req, **kw):
    ids, neg, imgs, lat = _port_request(req)
    pipe = EdgeStylePipeline(W.TINY_PIPE, device="cpu")
    return pipe(from_jax_params(params, "cpu"), torch.from_numpy(ids), torch.from_numpy(neg),
                [torch.from_numpy(i) for i in imgs], num_inference_steps=2,
                **({"latents": torch.from_numpy(lat)} if not kw else kw))


# ------------------------------------------------------------- rows
def test_local_draws_take_each_cond_third():
    """A rank's draws are its rows of the global draws; cond_eps stacks the
    three VAE conds' (b, ...) blocks, so each third gives its rows."""
    pipe = EdgeStylePipeline(W.TRAIN_CFG, device="cpu")
    host = next(train_app.synthetic_loader(train_app.parse_args(W.TRAIN_ARGV)))
    draws = sample_draws(pipe, TrainConfig(grad_accum=2), host, make_generator(1, "cpu"))
    for r in range(2):
        sl = slice(r, r + 1)
        for got, full in zip(local_draws(draws, sl, 2), draws):
            assert got.keys() == full.keys()
            for k, v in full.items():
                want = v.reshape(3, 2, *v.shape[1:])[:, sl].flatten(0, 1) \
                    if k == "cond_eps" else v[sl]
                assert torch.equal(got[k], want), k


def test_init_distributed_refuses_without_torchrun_or_a_card(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="missing RANK, WORLD_SIZE, MASTER_ADDR"):
        init_distributed("cpu")
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("cuda")


# ------------------------------------------------------------- (1) rules
def test_tp_rules_and_shards_match_jax(jax_tiny):
    """Every leaf of the TINY pipeline tree: the port's spec is JAX's, and on
    a (2, 2) mesh each rank's slice of the UNet and the CLIP text tower is
    JAX's shard on that device, transposed to the port's (out, in); the
    GEGLU's proj_in keeps the same share of each half, and a
    column-parallel bias its rows."""
    _, params = jax_tiny
    for sub, tree in params.items():
        for path, leaf in jflatten(tree).items():
            assert tp_spec_for_path(path, leaf.ndim) == tuple(jtp_spec_for_path(path, leaf.ndim)), path
    mesh = jmake_mesh(JMeshSpec(data=2, model=2), devices=jax.devices()[:4])
    heads = {"unet": W.TINY_PIPE.unet.num_heads, "clip": W.TINY_PIPE.clip.num_heads}
    sharded = 0
    for sub, nh in heads.items():
        jsh = jflatten(jshard_params_tp(mesh, params[sub]))
        full = {".".join(k): v for k, v in flatten(from_jax_params(params[sub], "cpu")).items()}
        for m in range(2):
            local = {".".join(k): v for k, v in
                     flatten(local_shard(from_jax_params(params[sub], "cpu"), m, 2, nh)).items()}
            for path, arr in jsh.items():
                got, ref = local[path].numpy(), full[path].numpy()
                spec = tuple(jtp_spec_for_path(path, arr.ndim))
                shard = next(s.data for s in arr.addressable_shards
                             if s.device == mesh.devices[0, m])
                if path.endswith("ff.proj_in.kernel") or path.endswith("ff.proj_in.bias"):
                    h = ref.shape[0] // 2
                    want = np.concatenate([ref[m * h // 2:(m + 1) * h // 2],
                                           ref[h + m * h // 2:h + (m + 1) * h // 2]])
                elif spec and path.endswith("kernel"):
                    want = np.asarray(shard).T
                    sharded += 1
                elif path.endswith("bias") and tp_spec_for_path(path[:-4] + "kernel", 2) == \
                        (None, "model"):
                    n = ref.shape[0] // 2
                    want = ref[m * n:(m + 1) * n]
                else:
                    want = ref
                np.testing.assert_array_equal(got, want, err_msg=path)
    assert sharded > 0


def test_tp_keeps_attention_whole_where_heads_do_not_divide(jax_tiny):
    """The VAE's single-head attention matches the column rule in JAX, but a
    rank must hold whole heads: with num_heads 1 it stays whole, as does
    every kernel whose split dimension does not divide."""
    _, params = jax_tiny
    vae = from_jax_params(params["vae"], "cpu")
    local = flatten(local_shard(vae, 1, 2, num_heads=1))
    assert all(v is flatten(vae)[k] for k, v in local.items())
    odd = flatten(local_shard(from_jax_params(params["clip"], "cpu"), 0, 3))
    assert all(v.shape == flatten(from_jax_params(params["clip"], "cpu"))[k].shape
               for k, v in odd.items())  # 32 and 24 do not divide 3


# ------------------------------------------------------------ (2) DP
def test_generate_dp_matches_jax_and_single_process(jax_tiny):
    """2 ranks, B=2, 2 UniPC steps: JAX's generate_dp on 2 devices and the
    port's single-process __call__ on the same latents, 1e-5; the global
    noise from a generator gives the single-process images; every rank
    returns the global batch; B=3 raises."""
    jpipe, params = jax_tiny
    req = _request(2, 1)
    jmesh = jmake_mesh(JMeshSpec(data=2, model=1), devices=jax.devices()[:2])
    ref = _jax_run(lambda *a, **k: jpipe.generate_dp(jmesh, params, *a, **k), req)
    single = nhwc(_single(params, req))
    drawn = nhwc(_single(params, req, generator=make_generator(4, "cpu")))
    ranks = run_ranks(W.generate_dp_rank, 2, (params, _port_request(req), 4))
    for r in ranks:
        np.testing.assert_array_equal(r["given"], ranks[0]["given"])
        np.testing.assert_allclose(nhwc(torch.from_numpy(r["given"])), ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(nhwc(torch.from_numpy(r["given"])), single, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(nhwc(torch.from_numpy(r["drawn"])), drawn, atol=1e-5,
                                   rtol=1e-5)
        assert "not divisible by the data axis size 2" in r["raised"]


# ------------------------------------------------------------ (3) TP
def test_generate_tp_matches_jax_on_a_2x2_mesh(jax_tiny):
    """4 ranks, (data 2, model 2), B=2: JAX's generate_tp on 4 devices within
    2e-4 (its own tolerance), every rank the same images, each rank's UNet
    shard by its model coordinate, and the all-reduces the code predicts:
    3 a transformer block per model evaluation (the UNet and the three
    batched trunk calls, 2 steps) and 1 a CLIP layer."""
    jpipe, params = jax_tiny
    req = _request(2, 2)
    jmesh = jmake_mesh(JMeshSpec(data=2, model=2), devices=jax.devices()[:4])
    ref = _jax_run(lambda *a, **k: jpipe.generate_tp(jmesh, params, *a, **k), req)
    ranks = run_ranks(W.generate_tp_rank, 4, (params, _port_request(req), (2, 2)))
    unet = flatten(from_jax_params(params["unet"], "cpu"))
    blocks = sum(1 for k in unet if k[-3:] == ("attn1", "to_q", "kernel"))
    trunk = sum(1 for k in flatten(from_jax_params(params["controlnet"]["static"], "cpu"))
                if k[-3:] == ("attn1", "to_q", "kernel"))
    groups = len({p for p in W.TINY_PIPE.pattern})
    want = 2 * 3 * (blocks + groups * trunk) + W.TINY_PIPE.clip.num_layers
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(nhwc(torch.from_numpy(out["images"])), ref, atol=2e-4,
                                   rtol=2e-4)
        np.testing.assert_array_equal(out["images"], ranks[0]["images"])
        assert out["coords"] == (r // 2, r % 2)
        assert out["all_reduces"] == want, (out["all_reduces"], want)
        q = out["unet"]["down_blocks_0.attentions_0.blocks_0.attn1.to_q.kernel"]
        full = unet[("down_blocks_0", "attentions_0", "blocks_0", "attn1", "to_q", "kernel")]
        np.testing.assert_array_equal(q, full[(r % 2) * 16:(r % 2 + 1) * 16].numpy())


# ------------------------------------------------------ (4) DP train steps
def _close(got, ref, what, rtol=1e-5):
    """Leaf by leaf: |got - ref| <= rtol * max|ref|. A leaf whose reference
    stays below 1e-4 of the tree's largest value is a zero up to roundoff
    (TINY's 32-channel GroupNorms, one channel a group, cancel their
    time-embedding projections, so those adapters' gradients are exactly 0
    but for roundoff, ~1e-9) and must stay below that too."""
    got, ref = flatten(got), flatten(ref)
    assert got.keys() == ref.keys(), what
    zero = 1e-4 * max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        a = np.asarray(got[k], np.float64)
        r = np.asarray(r, np.float64)
        if np.abs(r).max() < zero:
            assert np.abs(a).max() < zero, (what, k)
            continue
        err = np.abs(a - r).max()
        assert err <= rtol * np.abs(r).max(), (what, k, err, np.abs(r).max())


def _equal(got, ref, what):
    got, ref = flatten(got), flatten(ref)
    assert got.keys() == ref.keys(), what
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k], r, err_msg=f"{what} {k}")


def test_dp_train_and_distill_steps_match_single_process():
    """2 ranks, one sample each of a global micro-batch of 2: the train step
    (grad_accum 2, Prodigy) and the distill step (EMA) against the
    single-process steps on the same global batches and draws: the loss,
    d, every updated trainable, Prodigy's state and the EMA target within
    1e-5; the ranks' states bit for bit equal; one all-reduce of every
    gradient and loss a step."""
    ref = W.train_and_distill_steps(False)
    ranks = run_ranks(W.train_and_distill_steps, 2, (True,))
    for r in ranks:
        for what in ("state", "opt"):
            _close(r["train"][what], ref["train"][what], f"train {what}")
            _equal(r["train"][what], ranks[0]["train"][what], f"ranks {what}")
        _close(r["distill"]["state"], ref["distill"]["state"], "distill")
        _equal(r["distill"]["state"], ranks[0]["distill"]["state"], "ranks distill")
        for step in ("train", "distill"):
            assert abs(r[step]["loss"] - ref[step]["loss"]) <= 1e-5 * abs(ref[step]["loss"])
        assert abs(r["train"]["d"] - ref["train"]["d"]) <= 1e-5 * abs(ref["train"]["d"])
        numel = sum(v.size for v in flatten(ref["train"]["state"]).values()) + 2 + \
            sum(v.size for v in flatten(ref["distill"]["state"]["lcm_lora"]).values()) + 1
        assert r["bytes"] == 4 * numel


# ---------------------------------------------------------- (5) trainer
def test_train_main_on_two_ranks_matches_one(tmp_path):
    """apps/train.py::main at TINY width on the 512 px dataset under 2 ranks,
    global micro-batch 2: the log equals the 1-rank run's (1e-5), rank 0
    writes the one checkpoint, both ranks resume from it to the same
    state."""
    tree = make_tree(tmp_path / "ds")
    argv = ["--random_init", "--dataset_dir", tree, "--resolution", "512",
            "--train_batch_size", "2", "--gradient_accumulation_steps", "1",
            "--logging_steps", "1", "--controllora_linear_rank", "4",
            "--mixed_precision", "no", "--checkpointing_steps", "0"]
    out = str(tmp_path / "two")
    ranks = run_ranks(W.train_main_rank, 2,
                      (argv + ["--max_train_steps", "1", "--output_dir", out],
                       argv + ["--max_train_steps", "2", "--output_dir", out,
                               "--resume_from_checkpoint", "latest"]))
    one = train_app.main(argv + ["--max_train_steps", "1", "--output_dir", str(tmp_path / "one")],
                         device="cpu", base_cfg=W.DATA_CFG)
    assert checkpoint.list_checkpoints(out) == [1, 2]
    for r in ranks:
        assert [e["step"] for e in r["log"]] == [1] and [e["step"] for e in r["resumed_log"]] == [2]
        for key in ("loss", "d"):
            assert abs(r["log"][0][key] - one["log"][0][key]) <= 1e-5 * abs(one["log"][0][key])
            assert r["resumed_log"][0][key] == ranks[0]["resumed_log"][0][key]
        _equal(r["state"], ranks[0]["state"], "resumed ranks")


def test_train_main_refuses_a_micro_batch_the_ranks_cannot_share(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=r"--train_batch_size \(3\) must be divisible by the "
                                         r"device count \(2\)"):
        train_app.main(["--random_init", "--train_batch_size", "3"], device="cpu",
                       base_cfg=W.TRAIN_CFG)


# ---------------------------------------------------------- (6) dryrun
def test_dryrun_multichip_runs_its_stages():
    lines = dryrun_multichip(4)
    assert [line.split(": ", 1)[1].split(" ok")[0] for line in lines] == [
        "DP train step", "DP distill step", "DP batched generate",
        "TP(data=2, model=2) UNet forward", "DPxTP(data=2, model=2) train step",
        "sharded checkpoint save/restore", "DPxTP(data=2, model=2) generate"]
    assert "bit-identical resume" in lines[-2]

"""The port's DP x TP train step, its sharded resume and int8 under tensor
parallelism, against the JAX package and the single process, on CPU ranks.

The port's ranks are processes joined by ``gloo``
(core/mesh.py::run_ranks, tests/torch_multicard_workers.py), two scenarios
started once each: four ranks on the (data 2, model 2) mesh for the train
step, its checkpoints and the planted fault, and two model ranks for int8
``generate_tp``. fp32 at the TINY configuration (int8 at
tests/test_torch_quant.py's 64/128 channels, where the layers quantise).

Tolerances: the DP x TP step against the port's single-process step and
JAX's single-device step, the loss 1e-5 relative and each leaf 1e-5 of its
largest value (tests/test_torch_multicard.py::_close, with the Adam-type
eps-1 conditioning of the existing parity tests: tests/
torch_multicard_workers.py::TRAIN_ARGV); against the single process also
Prodigy's state, which carries the gradient (its first exp_avg is
(1 - beta1) d g: a wrong gradient moves a weight by less than its ulp at
d = 1e-6, the state not). The checkpoints and int8 are held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgestyle_tpu.core.mesh import MeshSpec as JMeshSpec
from edgestyle_tpu.core.mesh import make_mesh as jmake_mesh
from edgestyle_tpu.core.partitioning import shard_pipeline_frozen_tp as jshard_frozen_tp
from edgestyle_tpu.core.partitioning import tp_spec_for_path as jtp_spec_for_path
from edgestyle_tpu.core.porting import flatten as jflatten
from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
from edgestyle_tpu.training import train_step as jts
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.mesh import run_ranks
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.partitioning import Split, local_shard, tp_layout
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.models.unet import is_lora_linear_path, split_trunk_params
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests import torch_multicard_workers as W
from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE
from tests.test_torch_models import perturb
from tests.test_torch_multicard import _close
from tests.test_torch_quant import CFG as QUANT_CFG
from tests.test_torch_training_parity import jax_draws
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

J_TRAIN_CFG = dataclasses.replace(
    J_TINY_PIPE, clip=dataclasses.replace(J_TINY_PIPE.clip, vocab_size=49408, max_positions=77))
LIVE_SEED = 1
TOL = 1e-5


# ------------------------------------------------------------- (a) rules
def test_shard_pipeline_frozen_tp_matches_jax():
    """Each rank's slices of the train step's frozen set ({vae, clip, unet,
    static}) on a (2, 2) mesh equal JAX's shards on that device, leaf for
    leaf (transposed to the port's (out, in)); where the placements differ
    on purpose (core/partitioning.py): GEGLU's proj_in per half, a
    column-parallel bias sliced, the VAE's single-head attention whole."""
    pipe, frozen, _, _, _ = W.train_setup(LIVE_SEED)
    jfrozen = to_jax_params(frozen)
    mesh = jmake_mesh(JMeshSpec(data=2, model=2), devices=jax.devices()[:4])
    jsh = {k: jflatten(v) for k, v in jshard_frozen_tp(mesh, jfrozen).items()}
    heads = W.frozen_heads(pipe.cfg)
    full = {k: {".".join(p): v for p, v in flatten(tree).items()} for k, tree in frozen.items()}
    checked = {"sharded": 0, "per_half": 0, "bias": 0, "whole": 0}
    for m in range(2):
        for sub, tree in frozen.items():
            local = {".".join(p): v for p, v in
                     flatten(local_shard(tree, m, 2, heads[sub])).items()}
            for path, arr in jsh[sub].items():
                got, ref = local[path].numpy(), full[sub][path].numpy()
                spec = tuple(jtp_spec_for_path(path, arr.ndim))
                shard = np.asarray(next(s.data for s in arr.addressable_shards
                                        if s.device == mesh.devices[0, m]))
                if path.endswith(("ff.proj_in.kernel", "ff.proj_in.bias")):
                    h = ref.shape[0] // 2
                    want = np.concatenate([ref[m * h // 2:(m + 1) * h // 2],
                                           ref[h + m * h // 2:h + (m + 1) * h // 2]])
                    checked["per_half"] += 1
                elif sub == "vae":
                    want = ref  # one head: a rank must hold it whole
                    if spec:
                        assert shard.shape != ref.T.shape, path  # JAX splits it
                        checked["whole"] += 1
                elif spec and path.endswith("kernel"):
                    want = shard.T
                    checked["sharded"] += 1
                elif path.endswith("bias") and jtp_spec_for_path(
                        path[:-4] + "kernel", 2) == jax.sharding.PartitionSpec(None, "model"):
                    n = ref.shape[0] // 2
                    want = ref[m * n:(m + 1) * n]
                    checked["bias"] += 1
                else:
                    want = ref
                np.testing.assert_array_equal(got, want, err_msg=f"{sub} {path} rank {m}")
    assert all(checked.values()), checked


def test_tp_layout_is_local_shards_rule():
    """tp_layout names exactly the leaves local_shard slices, and
    Split.place puts every rank's share back into the global leaf."""
    _, frozen, _, _, _ = W.train_setup(LIVE_SEED)
    unet = frozen["unet"]
    layout = tp_layout(unet, 2, 2)
    shards = [flatten(local_shard(unet, m, 2, 2)) for m in range(2)]
    for path, v in flatten(unet).items():
        if path not in layout:
            assert all(s[path] is v for s in shards), path
            continue
        split = layout[path]
        out = torch.empty_like(v)
        for m in range(2):
            assert shards[m][path].shape == split.take(v, m, 2).shape
            split.place(out, shards[m][path], m, 2)
        assert tuple(out.shape) == split.global_shape(shards[0][path].shape, 2)
        assert torch.equal(out, v), path
    assert layout[("mid_block", "attentions_0", "blocks_0", "ff", "proj_in", "kernel")] == \
        Split("model", 0, 2)


# ------------------------------------------------ (b, c) four DP x TP ranks
@pytest.fixture(scope="module")
def dptp(tmp_path_factory):
    """JAX's single-device step (jitted once) on the live state and its
    draws, the port's single-process step on the same draws, and the four
    ranks' runs (tests/torch_multicard_workers.py::dptp_rank)."""
    pipe, frozen, tcfg, state, host = W.train_setup(LIVE_SEED)
    jcfg = jts.TrainConfig(**{f.name: getattr(tcfg, f.name)
                              for f in dataclasses.fields(jts.TrainConfig)})
    jpipe = JPipeline(J_TRAIN_CFG, attn_impl="xla")
    jtrainable = jax.tree.map(jnp.asarray, to_jax_params(state["trainable"]))
    jstate = {"trainable": jtrainable, "opt_state": jts.make_optimizer(jcfg).init(jtrainable),
              "step": jnp.zeros([], jnp.int32)}
    jbatch = {k: jnp.asarray(v if k == "input_ids" else v.transpose(0, 1, 3, 4, 2))
              for k, v in host.items()}
    rng = jax.random.key(5)
    jnew, jm = jax.jit(jts.make_train_step(jpipe, jcfg))(
        jstate, jax.tree.map(jnp.asarray, to_jax_params(frozen)), jbatch, rng)
    draws = []
    for _ in range(tcfg.grad_accum):
        rng, r = jax.random.split(rng)
        draws.append({k: v.numpy() for k, v in jax_draws(r, host["original"].shape[1]).items()})
    jax_out = {"loss": float(jm["loss"]),
               "state": W.numpy_tree(from_jax_params(jax.tree.map(np.asarray,
                                                                  jnew["trainable"]), "cpu"))}
    single = W.dptp_single(draws, LIVE_SEED)
    ranks = run_ranks(W.dptp_rank, 4, (draws, LIVE_SEED, str(tmp_path_factory.mktemp("ckpt"))))
    return {"jax": jax_out, "single": single, "ranks": ranks, "pipe": pipe, "frozen": frozen,
            "trainable": state["trainable"], "grad_accum": tcfg.grad_accum}


def test_dptp_step_matches_single_process_and_jax(dptp):
    """The DP x TP step (grad_accum 2, one row a data rank, live adapters):
    the loss and every trainable against JAX's single-device step, and
    also Prodigy's state against the port's single-process step; the ranks
    bit for bit equal; each rank's UNet slice by its model coordinate."""
    jax_out, single = dptp["jax"], dptp["single"]
    unet_q = flatten(dptp["frozen"]["unet"])[
        ("down_blocks_0", "attentions_0", "blocks_0", "attn1", "to_q", "kernel")]
    for r in dptp["ranks"]:
        step = r["step"]
        assert abs(step["loss"] - jax_out["loss"]) <= TOL * abs(jax_out["loss"])
        assert abs(step["loss"] - single["loss"]) <= TOL * abs(single["loss"])
        assert abs(step["d"] - single["d"]) <= TOL * abs(single["d"])
        _close(step["state"], jax_out["state"], "DPxTP vs JAX", TOL)
        _close(step["state"], single["state"], "DPxTP vs single", TOL)
        for key, tree in single["opt"].items():  # each on its own scale; exp_avg_sq
            # is (1 - beta2) (d g)^2, whose relative error is twice g's
            _close({key: step["opt"][key]}, {key: tree}, f"DPxTP vs single {key}",
                   2 * TOL if key == "exp_avg_sq" else TOL)
        for what in ("state", "opt"):
            for k, v in flatten(dptp["ranks"][0]["step"][what]).items():
                np.testing.assert_array_equal(flatten(step[what])[k], v, err_msg=f"{what} {k}")
        m = r["coords"][1]
        n = unet_q.shape[0] // 2
        np.testing.assert_array_equal(r["to_q"], unet_q[m * n:(m + 1) * n].numpy())


def test_dptp_step_fails_without_the_lora_merge_sum(dptp):
    """The planted fault: with the merge's CopyToModel left out, each rank
    keeps its slice's partial gradient of every adapter on a sliced kernel,
    and Prodigy's state leaves the single process's by far more than the
    tolerance (the loss, a forward quantity, stays)."""
    single = dptp["single"]
    for r in dptp["ranks"]:
        with pytest.raises(AssertionError):
            _close(r["fault"]["opt"]["exp_avg"], single["opt"]["exp_avg"], "fault", TOL)
        worst = max(np.abs(v - flatten(single["opt"])[k]).max() / np.abs(v).max()
                    for k, v in flatten(r["fault"]["opt"]).items()
                    if k[0] == "exp_avg" and "to_q" in k and np.abs(v).max() > 0)
        assert worst > 0.1, worst


def test_dptp_all_reduces_are_the_codes_count(dptp):
    """Per micro-batch, forward: 3 a transformer block (attn1, attn2, ff)
    of the UNet and of each of the three trunk calls, 1 a CLIP layer;
    backward, through CopyToModel: 3 a block where the input carries a
    gradient (the UNet's up blocks, the two LoRA trunks), and 1 a LoRA
    adapter leaf on a sliced kernel of each LoRA trunk."""
    cfg = dptp["pipe"].cfg
    unet = flatten(dptp["frozen"]["unet"])

    def blocks(prefix=""):
        return sum(1 for k in unet if k[-3:] == ("attn1", "to_q", "kernel")
                   and k[0].startswith(prefix))

    trunk = blocks("down_blocks") + blocks("mid_block")
    sliced = tp_layout(split_trunk_params(dptp["frozen"]["unet"]), 2, cfg.unet.num_heads)
    adapters = sum(2 for k in flatten(dptp["trainable"]["lora_0"])
                   if k[-1] == "down" and k[:-1] in sliced and is_lora_linear_path(k[:-1]))
    lora_trunks = len({p for p in cfg.pattern if p is not None})
    forward = 3 * (blocks() + len(dptp["pipe"].mcn.groups) * trunk) + cfg.clip.num_layers
    backward = 3 * (blocks("up_blocks") + lora_trunks * trunk) + lora_trunks * adapters
    assert adapters > 0
    for r in dptp["ranks"]:
        assert (r["forward"], r["backward"]) == (dptp["grad_accum"] * forward,
                                                 dptp["grad_accum"] * backward)


def test_sharded_resume_is_bit_exact(dptp):
    """The DP x TP state saved (rank 0 writes) and resumed with
    load_checkpoint_sharded on every rank: bit for bit, and one more step
    from the resumed state equals one from the live state bit for bit."""
    for r in dptp["ranks"]:
        assert r["resumed_equal"] and r["next_step_equal"]


def test_sharded_checkpoint_of_split_leaves(dptp):
    """The counterpart of tests/test_checkpoint.py's sharded test:
    replicated leaves, a leaf split over data by rows (a -0.0 among them),
    a column-parallel kernel and its bias and a GEGLU proj_in over model:
    the file holds the global leaves, each rank resumes its own share bit
    for bit, and a template leaf that is neither the global shape nor a
    share of it raises."""
    for r in dptp["ranks"]:
        assert r["split_equal"] and r["split_file_global"]
        assert "/trainable/a: the template's (3, 2) is not the checkpoint's (3, 3)" in \
            r["bad_shape_raised"]


@pytest.mark.parametrize("kw", [{"mesh": "a mesh"}, {"layout": {}}])
def test_save_checkpoint_takes_mesh_and_layout_together(tmp_path, kw):
    """A mesh without a layout (which would gather nothing) or a layout
    without its mesh raises before anything is written."""
    from edgestyle_tpu_torch.training.checkpoint import list_checkpoints, save_checkpoint

    with pytest.raises(ValueError, match="mesh and layout go together"):
        save_checkpoint(str(tmp_path), {"trainable": {"a": torch.ones(2)}, "step": 1}, **kw)
    assert list_checkpoints(str(tmp_path)) == []


def test_make_train_step_takes_one_averaging_group():
    """Under a model group the step averages over the whole mesh, so a data
    group beside it raises."""
    from edgestyle_tpu_torch.training.train_step import TrainConfig, make_train_step

    with pytest.raises(ValueError, match="pass no data_group"):
        make_train_step(None, TrainConfig(), data_group="data", model_group="model")


# ------------------------------------------------------- (d) int8 under TP
@pytest.fixture(scope="module")
def int8_tp():
    params = perturb(to_jax_params(EdgeStylePipeline(QUANT_CFG, device="cpu").init_params(
        make_generator(0, "cpu"))), np.random.default_rng(0))
    rng = np.random.default_rng(1)
    ids, neg = rng.integers(1, 99, size=(2, 1, QUANT_CFG.clip.max_positions))
    imgs = [(rng.standard_normal((1, 3, 32, 32)) * 0.5).astype(np.float32)
            for _ in QUANT_CFG.pattern]
    lat = rng.standard_normal((1, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, QUANT_CFG.clip.max_positions,
                               QUANT_CFG.clip.hidden_size)).astype(np.float32)
    args = (QUANT_CFG, params, (ids, neg, imgs, lat), ctx)
    return W.int8_tp_run(*args), run_ranks(W.int8_tp_rank, 2, args), params


def test_int8_generate_tp_matches_single_process(int8_tp):
    """int8 and int8-static generate_tp at model 2 against the single
    process: every row-parallel Dense of the denoise step is quantised at
    this width, so the int8 products (COUNTS), the calibration table and
    one denoise step on a shared context are equal bit for bit, and so are
    the 2-step images, and a row-parallel Dense whose plain kernel is
    quantised in the scope (its shard's rows maxed over the group) equals
    the whole Dense's int8 product. Each transformer block has three row-parallel
    Denses, each taking two model-group collectives (its scale's max, its
    int32 sum) on a dynamic scale and one (the sum) on a static one, in
    every model evaluation (the UNet and one trunk call a branch group):
    2 steps under "int8"; 5 calibration timesteps (dynamic, recorded) and 2
    steps under "int8-static". The text tower runs whole: no collective."""
    single, ranks, params = int8_tp

    def blocks(tree):
        return sum(1 for k in flatten(from_jax_params(tree, "cpu"))
                   if k[-3:] == ("attn1", "to_q", "kernel"))

    groups = len(EdgeStylePipeline(QUANT_CFG, device="cpu").mcn.groups)
    per_eval = 3 * (blocks(params["unet"]) + groups * blocks(params["controlnet"]["static"]))
    for r in ranks:
        assert r["int8"]["all_reduces"] == 2 * 2 * per_eval
        assert r["int8-static"]["all_reduces"] == 5 * 2 * per_eval + 2 * per_eval
        for mode in ("int8", "int8-static"):
            assert r[mode]["counts"] == single[mode]["counts"]
            assert single[mode]["counts"]["dense"] > 0
            np.testing.assert_array_equal(r[mode]["images"], single[mode]["images"])
        assert r["int8-static"]["table"] == single["int8-static"]["table"]
        np.testing.assert_array_equal(r["row_plain"], single["row_plain"])
        np.testing.assert_array_equal(r["step"], single["step"])

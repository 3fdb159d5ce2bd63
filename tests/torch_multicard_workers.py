"""The rank functions of tests/test_torch_multicard.py.

Each runs in a process of its own, started by
``edgestyle_tpu_torch.core.mesh.run_ranks`` (``gloo`` on the CPU), so this
module imports torch and the port only: a spawned rank re-imports it, and
JAX would cost every rank its import. Inputs and results are numpy.
"""

import dataclasses

import numpy as np
import torch

from edgestyle_tpu_torch.core import mesh as M
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.entry import DRYRUN_TINY
from edgestyle_tpu_torch.models.vae import VAEConfig
from edgestyle_tpu_torch.ops import tp

# tests/test_torch_pipeline.py::TINY_PIPE (the dryrun's config) and
# tests/test_torch_training.py::TRAIN_CFG
TINY_PIPE = DRYRUN_TINY
TRAIN_CFG = dataclasses.replace(
    TINY_PIPE, clip=dataclasses.replace(TINY_PIPE.clip, vocab_size=49408, max_positions=77))
# tests/test_torch_data.py::DATA_CFG: a five-level VAE keeps 512 px latents at 32 x 32
DATA_CFG = dataclasses.replace(
    TRAIN_CFG, vae=VAEConfig(block_out_channels=(32,) * 5, layers_per_block=1),
    unet=dataclasses.replace(TRAIN_CFG.unet, cond_embedding_channels=(8, 8, 8, 8, 16)))
# Conditioned as tests/test_torch_distill.py::test_distill_step_matches_jax:
# an Adam-type first step is ~lr sign(g) at eps 1e-8, so an element whose
# gradient is near roundoff would take either sign on either side; at eps 1,
# above every |g|, the update follows g and agrees as the gradients do. The
# distiller's default pseudo-Huber at c = 0.001 is the same coin-flip one
# level up (its gradient is ~sign(diff)), so the distill step runs l2.
TRAIN_ARGV = ["--random_init", "--resolution", "32", "--train_batch_size", "2",
              "--gradient_accumulation_steps", "2", "--controllora_linear_rank", "4",
              "--mixed_precision", "no", "--seed", "3", "--adam_epsilon", "1"]
DISTILL_ARGV = ["--random_init", "--resolution", "32", "--train_batch_size", "2",
                "--gradient_accumulation_steps", "1", "--lora_rank", "4",
                "--mixed_precision", "no", "--ema_decay", "0.9", "--seed", "5",
                "--adam_epsilon", "1", "--learning_rate", "1", "--max_grad_norm", "0.1",
                "--loss_type", "l2"]


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _request(inputs):
    ids, neg, imgs, lat = inputs
    return (torch.from_numpy(ids), torch.from_numpy(neg), [torch.from_numpy(i) for i in imgs],
            torch.from_numpy(lat))


def generate_dp_rank(params_np, inputs, seed: int):
    """generate_dp on the given latents, then on ``seed``'s generator; B=3
    must raise before any collective."""
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.core.porting import from_jax_params
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

    dev = M.init_distributed("cpu")
    mesh = M.make_mesh(device=dev)
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    params = M.replicate_params(mesh, from_jax_params(params_np, "cpu"))
    ids, neg, imgs, lat = _request(inputs)
    given = pipe.generate_dp(mesh, params, ids, neg, imgs, latents=lat, num_inference_steps=2)
    drawn = pipe.generate_dp(mesh, params, ids, neg, imgs,
                             generator=make_generator(seed, "cpu"), num_inference_steps=2)
    try:
        pipe.generate_dp(mesh, params, ids[:1].repeat(3, 1), neg[:1].repeat(3, 1),
                         [im[:1].repeat(3, 1, 1, 1) for im in imgs], latents=None,
                         generator=make_generator(seed, "cpu"), num_inference_steps=1)
        raised = ""
    except ValueError as e:
        raised = str(e)
    return {"given": given.numpy(), "drawn": drawn.numpy(), "raised": raised}


def generate_tp_rank(params_np, inputs, spec):
    """generate_tp on a (data, model) mesh: the images, this rank's UNet
    shard and its all-reduce count."""
    from edgestyle_tpu_torch.core.partitioning import shard_params_tp
    from edgestyle_tpu_torch.core.porting import from_jax_params
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

    dev = M.init_distributed("cpu")
    mesh = M.make_mesh(M.MeshSpec(*spec), device=dev)
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    params = from_jax_params(params_np, "cpu")
    ids, neg, imgs, lat = _request(inputs)
    tp.ALL_REDUCES[0] = 0
    out = pipe.generate_tp(mesh, params, ids, neg, imgs, latents=lat, num_inference_steps=2)
    unet = shard_params_tp(mesh, params["unet"], num_heads=TINY_PIPE.unet.num_heads)
    return {"images": out.numpy(), "all_reduces": tp.ALL_REDUCES[0],
            "unet": {".".join(k): v.numpy() for k, v in flatten(unet).items()},
            "coords": (M.axis_index(mesh, M.DATA_AXIS), M.axis_index(mesh, M.MODEL_AXIS))}


def train_and_distill_steps(data_parallel: bool):
    """One ControlLoRA train step (grad_accum 2) and one LCM-LoRA distill
    step (EMA), from the apps' builds at TINY width, each on a global
    batch of 2 from the synthetic loader and the global draws; with
    ``data_parallel`` each rank takes its rows and the steps average over
    the ranks. Returns both new states, the metrics and the reduced bytes."""
    from edgestyle_tpu_torch.apps import distill as distill_app
    from edgestyle_tpu_torch.apps import train as train_app
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids
    from edgestyle_tpu_torch.training.distill import make_distill_step, sample_distill_draws
    from edgestyle_tpu_torch.training.train_step import make_train_step, sample_draws

    mesh = group = None
    if data_parallel:
        mesh = M.make_mesh(device=M.init_distributed("cpu"))
        group = mesh.get_group(M.DATA_AXIS)
    M.ALL_REDUCE_BYTES[0] = 0
    out = {}

    args = train_app.parse_args(TRAIN_ARGV)
    pipe, frozen, tcfg, state, _ = train_app.build(args, "cpu", TRAIN_CFG)
    host = next(train_app.synthetic_loader(args))
    draws = sample_draws(pipe, tcfg, host, make_generator(11, "cpu"))
    batch, draws = train_app.rank_batch(mesh, host, draws)
    state, metrics = make_train_step(pipe, tcfg, data_group=group)(state, frozen, batch, draws)
    out["train"] = {"state": numpy_tree(state["trainable"]),
                    "opt": numpy_tree(state["opt_state"]),
                    "loss": float(metrics["loss"]), "d": float(metrics["d"])}

    dargs = distill_app.parse_args(DISTILL_ARGV)
    pipe, frozen, dcfg, dstate = distill_app.build(dargs, "cpu", TRAIN_CFG)
    ids = torch.from_numpy(empty_prompt_ids(1, pipe.cfg.clip.max_positions)).long()
    with torch.no_grad():
        uncond = pipe.clip(frozen["clip"], ids)["last_hidden_state"]
    host = next(train_app.synthetic_loader(dargs))
    draws = sample_distill_draws(pipe, dcfg, host, make_generator(12, "cpu"))
    batch, draws = train_app.rank_batch(mesh, host, draws)
    dstate, dmetrics = make_distill_step(pipe, dcfg, data_group=group)(
        dstate, frozen, batch, uncond, draws)
    out["distill"] = {"state": numpy_tree({"lcm_lora": dstate["lcm_lora"],
                                           "target": dstate["target"]}),
                      "loss": float(dmetrics["loss"])}
    out["bytes"] = M.ALL_REDUCE_BYTES[0]
    return out


def train_main_rank(argv, resume_argv):
    """apps/train.py::main under torchrun's environment, then its resume."""
    from edgestyle_tpu_torch.apps import train as train_app

    first = train_app.main(argv, device="cpu", base_cfg=DATA_CFG)
    again = train_app.main(resume_argv, device="cpu", base_cfg=DATA_CFG)
    return {"log": first["log"], "resumed_log": again["log"],
            "state": numpy_tree(again["state"]["trainable"])}


# ------------------------------------------- tests/test_torch_dptp.py
DPTP_SPEC = (2, 2)  # (data, model)


def live_state(state, tcfg, seed: int):
    """``state`` with every trainable moved by seeded N(0, 0.05^2) noise (the
    zero-init LoRA ups and heads too, so every adapter's gradient is live)
    and a fresh optimizer state."""
    from edgestyle_tpu_torch.core.params import unflatten
    from edgestyle_tpu_torch.training.train_step import make_optimizer

    g = torch.Generator().manual_seed(seed)
    trainable = unflatten({k: v + 0.05 * torch.randn(v.shape, generator=g)
                           for k, v in flatten(state["trainable"]).items()})
    return {"trainable": trainable, "opt_state": make_optimizer(tcfg).init(trainable),
            "step": 0}


def train_setup(live_seed: int):
    """The trainer's TINY build (TRAIN_ARGV: grad_accum 2, global micro-batch
    2, Prodigy at eps 1) with live trainables, and its host batch."""
    from edgestyle_tpu_torch.apps import train as train_app

    args = train_app.parse_args(TRAIN_ARGV)
    pipe, frozen, tcfg, state, _ = train_app.build(args, "cpu", TRAIN_CFG)
    return pipe, frozen, tcfg, live_state(state, tcfg, live_seed), \
        next(train_app.synthetic_loader(args))


def frozen_heads(cfg):
    return {"vae": 1, "clip": cfg.clip.num_heads, "unet": cfg.unet.num_heads,
            "static": cfg.unet.num_heads}


def _torch_draws(draws_np):
    return [{k: torch.from_numpy(v) for k, v in d.items()} for d in draws_np]


def _step_out(state, metrics):
    return {"state": numpy_tree(state["trainable"]), "opt": numpy_tree(state["opt_state"]),
            "loss": float(metrics["loss"]), "d": float(metrics["d"])}


def _states_bit_equal(a, b) -> bool:
    from edgestyle_tpu_torch.training.checkpoint import states_equal

    return states_equal(a, b)


def dptp_rank(draws_np, live_seed: int, root: str):
    """One rank of the DP x TP train step on the (2, 2) mesh: the step from
    the live state on the rank's rows, its all-reduce counts, the sharded
    save and resume of the new state (bit for bit, and one more step from
    each equal bit for bit), a save and resume of leaves split over data
    and over model, and the step with the LoRA merge's model-group sum
    left out."""
    import os
    import types

    from edgestyle_tpu_torch.apps import train as train_app
    from edgestyle_tpu_torch.core.partitioning import (
        Split,
        shard_pipeline_frozen_tp,
        tp_layout,
    )
    from edgestyle_tpu_torch.models import unet as unet_module
    from edgestyle_tpu_torch.training.checkpoint import (
        load_checkpoint,
        load_checkpoint_sharded,
        save_checkpoint,
    )
    from edgestyle_tpu_torch.training.train_step import make_train_step

    dev = M.init_distributed("cpu")
    mesh = M.make_mesh(M.MeshSpec(*DPTP_SPEC), dev)
    pipe, frozen, tcfg, state, host = train_setup(live_seed)
    batch, draws = train_app.rank_batch(mesh, host, _torch_draws(draws_np))
    local = shard_pipeline_frozen_tp(mesh, frozen, frozen_heads(pipe.cfg))
    step = make_train_step(pipe, tcfg, model_group=mesh.get_group(M.MODEL_AXIS))
    tp.ALL_REDUCES[0] = tp.BACKWARD_ALL_REDUCES[0] = 0
    new, metrics = step(state, local, batch, draws)
    out = {"step": _step_out(new, metrics), "forward": tp.ALL_REDUCES[0],
           "backward": tp.BACKWARD_ALL_REDUCES[0],
           "coords": (M.axis_index(mesh, M.DATA_AXIS), M.axis_index(mesh, M.MODEL_AXIS)),
           "to_q": numpy_tree(local["unet"]["down_blocks_0"]["attentions_0"]["blocks_0"]
                              ["attn1"]["to_q"]["kernel"])}

    # the sharded resume of the DP x TP state, then one step from each
    save_checkpoint(os.path.join(root, "dptp"), new)
    resumed = load_checkpoint_sharded(os.path.join(root, "dptp"), new, mesh)
    out["resumed_equal"] = _states_bit_equal(resumed, new)
    live2, _ = step(new, local, batch, draws)
    resumed2, _ = step(resumed, local, batch, draws)
    out["next_step_equal"] = _states_bit_equal(live2, resumed2)

    # leaves split over data (rows) and over model (a column-parallel kernel
    # and its bias, a GEGLU proj_in per half), replicated ones beside them
    g = torch.Generator().manual_seed(3)
    glob = {"rows": torch.randn((4, 5), generator=g),
            "attn1": {"to_q": {"kernel": torch.randn((8, 6), generator=g)}},
            "ff": {"proj_in": {"kernel": torch.randn((16, 4), generator=g),
                               "bias": torch.randn((16,), generator=g)}},
            "a": torch.randn((3, 3), generator=g)}
    glob["rows"][0, 0] = -0.0
    ntp = M.axis_size(mesh, M.MODEL_AXIS)
    layout = {("trainable",) + k: s for k, s in tp_layout(glob, ntp).items()}
    layout[("trainable", "rows")] = Split(M.DATA_AXIS, 0)
    mine = {("trainable",) + k: v for k, v in flatten(glob).items()}
    for path, split in layout.items():
        mine[path] = split.take(mine[path], M.axis_index(mesh, split.axis),
                                M.axis_size(mesh, split.axis))
    from edgestyle_tpu_torch.core.params import unflatten

    split_state = {**unflatten(mine), "opt_state": {"m": torch.ones(2)}, "step": 7}
    save_checkpoint(os.path.join(root, "split"), split_state, mesh=mesh, layout=layout)
    back = load_checkpoint_sharded(os.path.join(root, "split"), split_state, mesh,
                                   layout=layout)
    out["split_equal"] = _states_bit_equal(back, split_state)
    out["split_file_global"] = _states_bit_equal(
        load_checkpoint(os.path.join(root, "split"), 7, "cpu"),
        {"trainable": glob, "opt_state": {"m": torch.ones(2)}, "step": 7})
    bad = {**split_state, "trainable": {**split_state["trainable"], "a": torch.zeros((3, 2))}}
    try:
        load_checkpoint_sharded(os.path.join(root, "split"), bad, mesh, layout=layout)
        out["bad_shape_raised"] = ""
    except ValueError as e:
        out["bad_shape_raised"] = str(e)

    # the planted fault: the merge's CopyToModel left out
    unet_module.tp = types.SimpleNamespace(copy_to_model=lambda x: x, size=tp.size,
                                           index=tp.index)
    try:
        faulty, fmetrics = step(state, local, batch, draws)
    finally:
        unet_module.tp = tp
    out["fault"] = _step_out(faulty, fmetrics)
    return out


def dptp_single(draws_np, live_seed: int):
    """The single-process step of :func:`dptp_rank` on the global batch."""
    from edgestyle_tpu_torch.training.train_step import make_train_step

    pipe, frozen, tcfg, state, host = train_setup(live_seed)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    new, metrics = make_train_step(pipe, tcfg)(state, frozen, batch, _torch_draws(draws_np))
    return _step_out(new, metrics)


def int8_tp_run(cfg, params_np, inputs, context_np=None, mesh=None,
                modes=("int8", "int8-static")):
    """Generations (2 steps) in each of ``modes`` and, given ``context_np``,
    one int8 denoise step on it, tensor-parallel on ``mesh``'s model ranks
    or in this process without one: images, int8 products, model-group
    collectives, the calibration table and the step's output."""
    from contextlib import nullcontext

    from edgestyle_tpu_torch.core.partitioning import shard_params_tp
    from edgestyle_tpu_torch.core.porting import from_jax_params
    from edgestyle_tpu_torch.ops import quant
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

    params = from_jax_params(params_np, "cpu")
    ids, neg, imgs, lat = _request(inputs)
    out = {}
    for mode in modes:
        pipe = EdgeStylePipeline(cfg, device="cpu", quant=mode)
        quant.reset_counts()
        tp.ALL_REDUCES[0] = 0
        kw = dict(latents=lat, num_inference_steps=2)
        img = (pipe.generate_tp(mesh, params, ids, neg, imgs, **kw) if mesh is not None
               else pipe(params, ids, neg, imgs, **kw))
        out[mode] = {"images": img.numpy(), "counts": dict(quant.COUNTS),
                     "all_reduces": tp.ALL_REDUCES[0], "table": pipe._int8_scales}
    # a row-parallel Dense with a plain kernel in the int8 scope: the rank's
    # columns quantised with the full rows' absmax (maxed over the group)
    g = torch.Generator().manual_seed(7)
    x, w = torch.randn((2, 64, 128), generator=g), torch.randn((96, 128), generator=g)
    b = torch.randn((96,), generator=g)
    with torch.no_grad(), quant.quantize_intercept(True):
        if mesh is None:
            out["row_plain"] = quant.quant_dense(x, w, b, torch.float32).numpy()
        else:
            from edgestyle_tpu_torch.models.layers import row_dense

            m = M.axis_index(mesh, M.MODEL_AXIS)
            with tp.model_parallel(mesh.get_group(M.MODEL_AXIS)):
                out["row_plain"] = row_dense(
                    {"kernel": w[:, 64 * m:64 * (m + 1)], "bias": b}, x[..., 64 * m:64 * (m + 1)],
                    96, torch.float32, True).numpy()
    if context_np is None:
        return out
    qp = pipe._quantized(params)
    ctx_mgr = nullcontext()
    if mesh is not None:
        qp = {k: v if k == "clip" else shard_params_tp(mesh, v, None if k != "vae" else 1)
              for k, v in qp.items()}
        ctx_mgr = tp.model_parallel(mesh.get_group(M.MODEL_AXIS))
    context = torch.from_numpy(context_np)
    with torch.no_grad(), ctx_mgr:
        embs = pipe.embed_cond_images(qp, imgs)
        embs2 = [torch.cat([e, e]) for e in embs]
        with quant.quantize_intercept(True):
            eps = pipe._eval_step(True, qp, context, embs, embs2,
                                  np.ones((cfg.num_branches,), np.float32),
                                  torch.tensor(2.0), lat.shape[0], False, lat, 499)
    out["step"] = eps.numpy()
    return out


def int8_tp_rank(cfg, params_np, inputs, context_np=None, modes=("int8", "int8-static")):
    dev = M.init_distributed("cpu")
    return int8_tp_run(cfg, params_np, inputs, context_np,
                       M.make_mesh(M.MeshSpec(data=1, model=2), dev), modes)

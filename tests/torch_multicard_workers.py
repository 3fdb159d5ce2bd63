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

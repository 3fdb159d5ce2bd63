"""The ControlLoRA trainer's entry point, on one card or data parallel on several.

Counterpart of edgestyle_tpu/apps/train.py, with its flag set and defaults
(:func:`parse_args`). Ported: the frozen weights from diffusers/HF
directories (``--pretrained_model`` with ``unet/`` and ``text_encoder/``,
``--vae``, ``--openpose_controlnet``; core/pretrained.py) or, with
``--random_init``, from ``--seed``; the extracted dataset
(``--dataset_dir``, data/dataset.py's layout: ``<subject>/{processed,
openpose, subject, agnostic, head, clothes}/<frame>.jpg``) with
``--max_train_samples`` and the five ``--proportion_*`` augmentations, or
without it the synthetic loader; the thread pool and background prefetch
of ``--dataloader_num_workers``; the step loop with its JSON log lines;
validation by generation every ``--validation_steps`` (logged to
TensorBoard through ``tensorboardX`` where it is installed, skipped where
it is not, as in the JAX trainer); checkpointing with rotation and resume,
the final checkpoint and the trained set's two exports
(``edgestyle_trainable.safetensors`` and the reference's ``controlnet/``
layout). Under ``torchrun --nproc_per_node N`` it trains data parallel
(:func:`main`).

    python -m edgestyle_tpu_torch.apps.train --random_init --resolution 512 \\
        --train_batch_size 2 --gradient_accumulation_steps 1 --max_train_steps 3
    python -m edgestyle_tpu_torch.apps.train --random_init --dataset_dir extracted \\
        --dataloader_num_workers 2 --validation_steps 100 --max_train_steps 1000
    python -m edgestyle_tpu_torch.apps.train --pretrained_model rv51 \\
        --vae sd-vae-ft-mse --openpose_controlnet openpose --max_train_steps 3
    torchrun --nproc_per_node 4 -m edgestyle_tpu_torch.apps.train --random_init \\
        --train_batch_size 4 --max_train_steps 3
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from edgestyle_tpu_torch.core.mesh import world_size

WEIGHT_DIRS = ("pretrained_model", "vae", "openpose_controlnet")
PROPORTIONS = ("proportion_empty_prompts", "proportion_empty_images",
               "proportion_patchworked_images", "proportion_cutout_images",
               "proportion_patchworks")


def _ref_bool(v: str) -> bool:
    """Reference-style bool flags take =True/=False values."""
    return str(v).lower() in ("1", "true", "yes")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle ControlLoRA trainer (PyTorch/CUDA)")
    # model sources
    p.add_argument("--pretrained_model", "--pretrained_model_name_or_path",
                   type=str, default=None, dest="pretrained_model")
    p.add_argument("--vae", "--pretrained_vae_name_or_path", type=str, default=None,
                   dest="vae")
    p.add_argument("--openpose_controlnet", "--pretrained_openpose_name_or_path",
                   type=str, default=None, dest="openpose_controlnet")
    p.add_argument("--random_init", action="store_true",
                   help="random-init all weights from --seed")
    # data
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--gradient_accumulation_steps", type=int, default=32)
    p.add_argument("--proportion_empty_prompts", type=float, default=0.0)
    p.add_argument("--proportion_empty_images", type=float, default=0.0)
    p.add_argument("--proportion_patchworked_images", type=float, default=0.0)
    p.add_argument("--proportion_cutout_images", type=float, default=0.0)
    p.add_argument("--proportion_patchworks", type=float, default=0.0)
    p.add_argument("--use_agnostic_images", action=argparse.BooleanOptionalAction,
                   default=False)
    # optimization (reference recipe: prodigy lr 1.0, snr_gamma 5)
    p.add_argument("--optimizer", type=str, default="prodigy", choices=["prodigy", "adamw"])
    p.add_argument("--learning_rate", type=float, default=1.0)
    p.add_argument("--scale_lr", action="store_true", default=False,
                   help="lr *= grad_accum * batch * device_count")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--snr_gamma", type=float, default=5.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--adam_weight_decay", type=float, default=1e-4)
    p.add_argument("--prodigy_beta3", type=float, default=None)
    p.add_argument("--prodigy_decouple", type=_ref_bool, default=True)
    p.add_argument("--prodigy_use_bias_correction", type=_ref_bool, default=True)
    p.add_argument("--prodigy_safeguard_warmup", type=_ref_bool, default=True)
    p.add_argument("--lr_scheduler", type=str, default="cosine_annealing",
                   help="diffusers get_scheduler names; cosine_annealing is an alias "
                        "of cosine")
    p.add_argument("--lr_num_cycles", type=float, default=1.0)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="None -> num_train_epochs * steps-per-epoch")
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--controllora_linear_rank", type=int, default=32)
    p.add_argument("--controllora_conv2d_rank", type=int, default=0,
                   help="adapt trunk convs too; >0 uses the LINEAR rank for the adapters "
                        "(the reference quirk)")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"], help="fp16 runs as bf16")
    p.add_argument("--seed", type=int, default=0)
    # checkpointing / logging
    p.add_argument("--output_dir", type=str, default="./edgestyle-tpu-out")
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--checkpointing_steps", type=int, default=100)
    p.add_argument("--checkpoints_total_limit", type=int, default=5)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--validation_steps", type=int, default=0)
    p.add_argument("--num_validation_images", type=int, default=4)
    p.add_argument("--logging_steps", type=int, default=10)
    # accepted for reference-CLI compatibility; no-ops here
    for flag, default in (("--revision", None), ("--variant", None),
                          ("--tokenizer_name", None), ("--cache_dir", None),
                          ("--report_to", "tensorboard"),
                          ("--tracker_project_name", "edgestyle-tpu")):
        p.add_argument(flag, type=str, default=default, help="compat no-op")
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute each micro-batch's activations in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--allow_tf32", action="store_true", help="compat no-op")
    p.add_argument("--set_grads_to_none", action="store_true", help="compat no-op")
    p.add_argument("--controllora_use_vae", action="store_true", default=True,
                   help="compat: the VAE conditioning embedding is always on")
    args = p.parse_args(argv)
    if args.resolution % 8 != 0:
        p.error("resolution must be divisible by 8")
    return args


def check_supported(args) -> None:
    """Refuse a run with no weights, and a micro-batch that the ranks
    cannot share."""
    missing = [f"--{n}" for n in WEIGHT_DIRS if not getattr(args, n)]
    if not args.random_init and missing:
        raise ValueError(f"without --random_init the weights come from --pretrained_model, "
                         f"--vae and --openpose_controlnet; missing {', '.join(missing)}")
    check_batch_divisible(args.train_batch_size, world_size())


def check_batch_divisible(train_batch_size: int, device_count: int) -> None:
    """Each rank takes train_batch_size / ranks samples of every
    micro-batch, so the ranks must divide it (the JAX trainer's check and
    message)."""
    if train_batch_size % device_count != 0:
        raise SystemExit(
            f"--train_batch_size ({train_batch_size}) must be divisible by "
            f"the device count ({device_count}): each device takes "
            f"train_batch_size/device_count samples of every micro-batch. "
            f"Raise --train_batch_size or lower "
            f"--gradient_accumulation_steps to keep the sample budget.")


def data_parallel(device):
    """(device, mesh): under torchrun (``WORLD_SIZE`` > 1) this rank's device
    from core/mesh.py::init_distributed and the all-data mesh; with one
    process, ``device`` and None."""
    if world_size() == 1:
        return device, None
    from edgestyle_tpu_torch.core.mesh import init_distributed, make_mesh

    dev = init_distributed(device)
    return dev, make_mesh(device=dev)


def rank_batch(mesh, batch, draws):
    """This rank's rows of a global (grad_accum, micro_bs, ...) host batch
    and of its draws (all of both with no mesh), the batch on the draws'
    device."""
    if mesh is not None:
        from edgestyle_tpu_torch.core.mesh import rows, shard_batch
        from edgestyle_tpu_torch.training.train_step import local_draws

        mb = batch["original"].shape[1]
        draws = local_draws(draws, rows(mesh, mb), mb)
        batch = shard_batch(mesh, batch, axis=1)
    dev = draws[0]["noise"].device
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, draws


def train_steps(args) -> int:
    """The loop's length: ``--max_train_steps``, else ``--num_train_epochs``
    epochs of the dataset's first ``--max_train_samples`` examples at
    ``--train_batch_size`` x ``--gradient_accumulation_steps`` a step (at
    least one step; reference train...py:1034-1038); the synthetic loader
    counts 1000 steps an epoch."""
    steps_per_epoch = 1000
    if args.dataset_dir:
        from edgestyle_tpu_torch.data.dataset import EdgeStyleLocalDataset

        n_samples = len(EdgeStyleLocalDataset(args.dataset_dir, resolution=args.resolution))
        if args.max_train_samples:
            n_samples = min(n_samples, args.max_train_samples)
        steps_per_epoch = max(
            n_samples // (args.train_batch_size * args.gradient_accumulation_steps), 1)
    return args.max_train_steps or args.num_train_epochs * steps_per_epoch


def bf16_leaves(tree, select=None):
    """``tree`` with its fp32 leaves cast to bf16 (norms too), or only the
    leaves for which ``select(path, leaf)`` holds. A tensor found at several
    paths (a ControlLoRA branch shares the UNet trunk's untouched leaves)
    is cast once and stays shared."""
    from edgestyle_tpu_torch.core.params import flatten, unflatten

    cast = {}

    def leaf(path, v):
        if v.dtype != torch.float32 or (select is not None and not select(path, v)):
            return v
        if id(v) not in cast:
            cast[id(v)] = v.to(torch.bfloat16)
        return cast[id(v)]

    return unflatten({k: leaf(k, v) for k, v in flatten(tree).items()})


def build_pipeline(args, device, base_cfg, fp32_weights: bool = False, **load_kw):
    """(pipe, gen, params): the pipeline of ``base_cfg`` (default full-width
    SD1.5) at the dtype of ``--mixed_precision`` and the VAE sample size of
    ``--resolution``, the generator of ``--seed``, and the weights, drawn
    from it with ``--random_init``, else read from the three directories
    (``load_kw`` goes on to load_pipeline_params). The weights come in the
    pipeline's dtype, norms fp32, or with ``fp32_weights`` all in fp32,
    through an fp32 twin of the pipeline (the same draws, unrounded)."""
    import dataclasses

    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.core.pretrained import load_pipeline_params
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

    # the fusion blocks' LayerNorm sizes follow --resolution
    base = base_cfg or PipelineConfig()
    cfg = dataclasses.replace(base, vae=dataclasses.replace(base.vae,
                                                            sample_size=args.resolution))
    dtype = "float32" if args.mixed_precision == "no" else "bfloat16"
    pipe = EdgeStylePipeline(dataclasses.replace(cfg, dtype=dtype), device=device)
    src = (EdgeStylePipeline(dataclasses.replace(cfg, dtype="float32"), device=device)
           if fp32_weights and dtype != "float32" else pipe)
    gen = make_generator(args.seed, pipe.device)
    if args.random_init:
        return pipe, gen, src.init_params(gen)
    return pipe, gen, load_pipeline_params(args.pretrained_model, args.vae,
                                           args.openpose_controlnet, pipe=src, generator=gen,
                                           **load_kw)


def build(args, device="cuda", base_cfg=None):
    """The pipeline, the frozen weights, the train config and the initial
    train state: the weights from the three directories or, with
    ``--random_init``, from ``--seed``; the trainables from ``--seed``.
    ``base_cfg``: the model configuration (default full-width SD1.5); its
    dtype and VAE sample size come from the flags. Returns (pipe, frozen,
    tcfg, state, max_train_steps)."""
    from edgestyle_tpu_torch.training.train_step import (
        TrainConfig,
        init_trainable,
        make_optimizer,
    )

    pipe, gen, params = build_pipeline(args, device, base_cfg,
                                       lora_rank=args.controllora_linear_rank)
    frozen = {"vae": params["vae"], "clip": params["clip"], "unet": params["unet"],
              "static": params["controlnet"]["static"]}
    if pipe.dtype == torch.bfloat16:
        # mixed precision: every frozen leaf is stored bf16 (norms too, as
        # in the JAX trainer); the trainables stay fp32 master weights
        frozen = bf16_leaves(frozen)
    max_train_steps = train_steps(args)
    lr = args.learning_rate
    if args.scale_lr:
        lr *= args.gradient_accumulation_steps * args.train_batch_size * world_size()
    tcfg = TrainConfig(
        snr_gamma=args.snr_gamma,
        max_grad_norm=args.max_grad_norm,
        remat=args.gradient_checkpointing,
        optimizer=args.optimizer,
        learning_rate=lr,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_epsilon=args.adam_epsilon,
        lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_total_steps=(None if args.lr_scheduler in ("constant", "constant_with_warmup")
                        else max_train_steps),
        lr_num_cycles=args.lr_num_cycles,
        lr_power=args.lr_power,
        prodigy_beta3=args.prodigy_beta3,
        prodigy_decouple=args.prodigy_decouple,
        prodigy_use_bias_correction=args.prodigy_use_bias_correction,
        prodigy_safeguard_warmup=args.prodigy_safeguard_warmup,
        weight_decay=args.adam_weight_decay,
        use_agnostic=args.use_agnostic_images,
        grad_accum=args.gradient_accumulation_steps,
    )
    trainable = init_trainable(pipe, gen, params["unet"], args.controllora_linear_rank,
                               args.controllora_conv2d_rank)
    del params
    state = {"trainable": trainable, "opt_state": make_optimizer(tcfg).init(trainable),
             "step": 0}
    return pipe, frozen, tcfg, state, max_train_steps


def synthetic_loader(args):
    """Random batches, the JAX trainer's ``_synthetic_loader`` arrays (the
    same numpy draws from ``--seed``) in NCHW: images (accum, mb, 3, res,
    res) float32, input_ids (accum, mb, 77) int64."""
    g = np.random.default_rng(args.seed)
    accum, mb, res = args.gradient_accumulation_steps, args.train_batch_size, args.resolution

    def img():
        a = g.standard_normal((accum, mb, res, res, 3)).astype(np.float32) * 0.2
        return np.ascontiguousarray(a.transpose(0, 1, 4, 2, 3))

    while True:
        yield {
            "original": img(), "agnostic": img(), "head": img(), "clothes": img(),
            "clothes2": img(), "original_openpose": np.abs(img()),
            "clothes_openpose": np.abs(img()), "clothes_openpose2": np.abs(img()),
            "input_ids": g.integers(1, 49000, (accum, mb, 77)).astype(np.int64),
        }


def dataset_loader(args):
    """The extracted dataset's shuffled loader (data/dataset.py::data_loader,
    the JAX trainer's batches bit for bit from ``--seed``), its images moved
    to NCHW as the synthetic loader gives them (on the prefetch thread when
    there is one) and its ids int64; the first ``--max_train_samples``
    examples of the index only. A caller without the ``--proportion_*``
    flags (the distiller) gets the collate's defaults, zeros."""
    from edgestyle_tpu_torch.data.dataset import EdgeStyleLocalDataset, data_loader
    from edgestyle_tpu_torch.training.train_step import BATCH_KEYS

    ds = EdgeStyleLocalDataset(args.dataset_dir, resolution=args.resolution)
    if args.max_train_samples:
        ds.index = ds.index[: args.max_train_samples]
    loader = data_loader(
        ds, args.train_batch_size * args.gradient_accumulation_steps,
        args.gradient_accumulation_steps, seed=args.seed,
        proportions={k: getattr(args, k, 0.0) for k in PROPORTIONS},
        num_workers=args.dataloader_num_workers)
    for batch in loader:
        yield {k: np.ascontiguousarray(v.transpose(0, 1, 4, 2, 3)) if v.ndim == 5
               else v.astype(np.int64) for k, v in batch.items() if k in BATCH_KEYS}


def summary_writer(args):
    """A tensorboardX writer under ``--output_dir/--logging_dir``, or None
    where tensorboardX is not installed (validation is then skipped, as in
    the JAX trainer)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(args.output_dir, args.logging_dir))


def main(argv=None, device="cuda", base_cfg=None):
    """Train; print one JSON line every ``--logging_steps`` and a final one.
    Returns {'state', 'frozen', 'log'}: the final train state, the frozen
    weights it trained against and the logged metrics. ``device`` and
    ``base_cfg`` as :func:`build` takes them.

    Under ``torchrun --nproc_per_node N`` (``WORLD_SIZE`` > 1) the ranks
    train data parallel (core/mesh.py): ``--train_batch_size`` is the
    global micro-batch, each rank takes its rows of every global batch
    (every rank reads the loader in the single-process order, and the same
    draws) and the gradients are averaged over the ranks each step; rank 0
    prints, logs, validates and writes the checkpoints and exports. Each
    rank runs on ``cuda:LOCAL_RANK`` unless ``device`` names one, over
    ``nccl`` (``gloo`` on the CPU)."""
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.core.mesh import DATA_AXIS, is_rank0, on_rank0, replicate_params
    from edgestyle_tpu_torch.core.pretrained import export_reference_layout
    from edgestyle_tpu_torch.training.checkpoint import (
        export_safetensors,
        load_checkpoint,
        save_checkpoint,
    )
    from edgestyle_tpu_torch.training.train_step import make_train_step, sample_draws

    args = parse_args(argv)
    check_supported(args)
    device, mesh = data_parallel(device)
    pipe, frozen, tcfg, state, max_train_steps = build(args, device, base_cfg)
    if args.resume_from_checkpoint:
        state = load_checkpoint(args.output_dir, args.resume_from_checkpoint
                                if args.resume_from_checkpoint == "latest"
                                else int(args.resume_from_checkpoint), pipe.device)
    if mesh is not None:
        # every rank drew or read the same weights; the state starts as rank 0's
        replicate_params(mesh, state)
    step_fn = make_train_step(pipe, tcfg,
                              data_group=None if mesh is None else mesh.get_group(DATA_AXIS))
    draw_gen = make_generator(args.seed + 1, pipe.device)
    loader = dataset_loader(args) if args.dataset_dir else synthetic_loader(args)
    if args.dataloader_num_workers > 0:
        # overlap the host's decode and collate with the card's steps
        from edgestyle_tpu_torch.data.prefetch import prefetch

        loader = prefetch(loader, depth=2)
    rank0 = is_rank0()
    writer = summary_writer(args) if rank0 else None
    log = []
    t0 = time.time()
    try:
        for host in loader:
            if state["step"] >= max_train_steps:
                break
            # the global batch's draws; each rank takes its rows of both
            batch, draws = rank_batch(mesh, host, sample_draws(pipe, tcfg, host, draw_gen))
            state, metrics = step_fn(state, frozen, batch, draws)
            gstep = state["step"]
            if gstep % args.logging_steps == 0:
                rec = {"step": gstep, "loss": float(metrics["loss"]), "d": float(metrics["d"]),
                       "elapsed_s": round(time.time() - t0, 3)}
                log.append(rec)
                if rank0:
                    print(json.dumps(rec), flush=True)
                if writer is not None:
                    writer.add_scalar("train_loss", rec["loss"], gstep)
                    writer.add_scalar("train_lr", rec["d"], gstep)
            if args.checkpointing_steps and gstep % args.checkpointing_steps == 0:
                save_checkpoint(args.output_dir, state, args.checkpoints_total_limit)
            if args.validation_steps and gstep % args.validation_steps == 0 and writer:
                from edgestyle_tpu_torch.training.validation import log_validation

                # the global batch's first micro-batch, capped at
                # --num_validation_images
                n = args.num_validation_images
                log_validation(pipe, frozen, state["trainable"],
                               {k: torch.from_numpy(v[0, :n]).to(pipe.device)
                                for k, v in host.items()}, gstep, writer,
                               num_inference_steps=8, use_agnostic=args.use_agnostic_images,
                               # the reference's sweep (train...py:146)
                               guidance_scales=tuple(np.linspace(3.0, 7.5, n)))
    finally:
        if hasattr(loader, "close"):
            loader.close()  # stops the prefetch thread (the source is infinite)
        if writer is not None:
            writer.close()
    save_checkpoint(args.output_dir, state, args.checkpoints_total_limit)
    # the deployable artifacts: the JAX package's flat file, and the
    # reference's layout (train...py:1373-1382), which the reference's torch
    # stack reads; --edgestyle_checkpoint of the try-on takes either
    export_safetensors(os.path.join(args.output_dir, "edgestyle_trainable.safetensors"),
                       state["trainable"])
    on_rank0(export_reference_layout, os.path.join(args.output_dir, "controlnet"),
             state["trainable"], unet_conv_in=frozen["unet"]["conv_in"])
    if rank0:
        print(json.dumps({"done": True, "final_step": state["step"]}), flush=True)
    return {"state": state, "frozen": frozen, "log": log}


if __name__ == "__main__":
    main()

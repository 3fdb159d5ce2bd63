"""The LCM-LoRA distiller's entry point, on one card or data parallel on several.

Counterpart of edgestyle_tpu/apps/distill.py, with its flag set, aliases,
defaults and choices (:func:`parse_args`). The frozen try-on stack (SD1.5
UNet + the trained six-branch MultiControlNet) teaches LCM-LoRA adapters
(training/distill.py) so the pipeline serves at 2-8 steps with
``--mode lcm --lcm_lora <output_dir>/lcm_lora.safetensors`` (apps/tryon.py).

The weights come from the trainer's three diffusers/HF directories and the
trained set (``--edgestyle_checkpoint``, a reference-layout directory or
an exported file; core/pretrained.py) or, with ``--random_init``, from
``--seed``; the batches from the extracted dataset (``--dataset_dir``,
``--max_train_samples``) or the trainer's synthetic loader, prefetched on a
thread with ``--dataloader_num_workers`` > 0. The step loop prints a JSON
line every ``--logging_steps`` (and logs the loss to TensorBoard through
``tensorboardX`` where it is installed), checkpoints with rotation and
resume (training/checkpoint.py), and ends with the final checkpoint and
``lcm_lora.safetensors``, written in the JAX package's layout, so either
package's ``--lcm_lora`` reads it. Under ``torchrun --nproc_per_node N``
it distils data parallel, as apps/train.py::main trains.

    python -m edgestyle_tpu_torch.apps.distill --random_init --max_train_steps 3
    python -m edgestyle_tpu_torch.apps.distill --random_init --distill_mode guidance \\
        --w_min 4 --max_train_steps 3
    python -m edgestyle_tpu_torch.apps.distill --pretrained_model rv51 --vae sd-vae-ft-mse \\
        --openpose_controlnet openpose --edgestyle_checkpoint trained \\
        --dataset_dir extracted --max_train_steps 2000
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle LCM-LoRA distillation (PyTorch/CUDA)")
    p.add_argument("--pretrained_model", "--pretrained_model_name_or_path",
                   type=str, default=None, dest="pretrained_model")
    p.add_argument("--vae", "--pretrained_vae_name_or_path", type=str, default=None, dest="vae")
    p.add_argument("--openpose_controlnet", "--pretrained_openpose_name_or_path", type=str,
                   default=None, dest="openpose_controlnet")
    p.add_argument("--edgestyle_checkpoint", "--controlnet_model_name_or_path", type=str,
                   default=None, dest="edgestyle_checkpoint",
                   help="trained try-on ControlNet set (reference-layout dir or trainable "
                        "safetensors); distillation conditions on it frozen")
    p.add_argument("--random_init", action="store_true",
                   help="random-init the whole stack from --seed")
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--use_agnostic_images", action=argparse.BooleanOptionalAction,
                   default=False)
    # distillation knobs (training/distill.py DistillConfig)
    p.add_argument("--distill_mode", type=str, default="consistency",
                   choices=["consistency", "guidance"],
                   help="consistency = LCM-LoRA few-step serving; guidance = CFG "
                        "distillation (serve at the same step count with guidance off; "
                        "pin the baked-in scale with --w_min/--w_max, w = guidance - 1)")
    p.add_argument("--lora_rank", type=int, default=64)
    p.add_argument("--num_ddim_timesteps", type=int, default=50)
    p.add_argument("--w_min", type=float, default=3.0)
    p.add_argument("--w_max", type=float, default=None,
                   help="upper end of the w ~ U[w_min, w_max) CFG range (consistency mode; "
                        "default 15); guidance mode needs one pinned scale, so it defaults "
                        "to w_min and any other value is rejected")
    p.add_argument("--loss_type", type=str, default="huber", choices=["huber", "l2"])
    p.add_argument("--huber_c", type=float, default=0.001)
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA target-network decay; unset = online target (the LCM-LoRA "
                        "simplification)")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--adam_weight_decay", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--max_train_steps", type=int, default=1000)
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "bf16", "fp16"], help="fp16 runs as bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", type=str, default="./edgestyle-lcm-out")
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--checkpointing_steps", type=int, default=100)
    p.add_argument("--checkpoints_total_limit", type=int, default=5)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--dataloader_num_workers", type=int, default=0)
    return p.parse_args(argv)


def distill_config(args):
    """The DistillConfig of the flags. Guidance mode regresses onto one
    baked-in scale (the student has no w input), so ``--w_max`` defaults to
    ``--w_min`` there and to 15 in consistency mode."""
    from edgestyle_tpu_torch.training.distill import DistillConfig

    w_max = args.w_max if args.w_max is not None else (
        args.w_min if args.distill_mode == "guidance" else 15.0)
    return DistillConfig(
        mode=args.distill_mode,
        lora_rank=args.lora_rank,
        num_ddim_timesteps=args.num_ddim_timesteps,
        w_min=args.w_min,
        w_max=w_max,
        loss_type=args.loss_type,
        huber_c=args.huber_c,
        ema_decay=args.ema_decay,
        learning_rate=args.learning_rate,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_epsilon=args.adam_epsilon,
        weight_decay=args.adam_weight_decay,
        max_grad_norm=args.max_grad_norm,
        grad_accum=args.gradient_accumulation_steps,
        use_agnostic=args.use_agnostic_images,
    )


def is_conv_kernel(path, leaf) -> bool:
    """A conv's (out, in, kh, kw) kernel, the leaves the mixed-precision
    distiller stores in bf16."""
    return path[-1] == "kernel" and leaf.ndim == 4


def build(args, device="cuda", base_cfg=None):
    """The pipeline, the frozen weights {vae, clip, unet, static,
    controlnet}, the distill config and the initial state: the weights from
    the three directories and ``--edgestyle_checkpoint`` or, with
    ``--random_init``, from ``--seed``; the adapters fp32 from the same
    generator. The frozen weights are held in fp32, as in the JAX
    distiller: norms, embeddings and the linears the adapters merge into
    are cast at use. Under mixed precision the conv kernels alone are
    stored bf16, the values each conv casts its kernel to at use in both
    packages, since the fused conv kernel takes a bf16 weight only
    (ops/fused_conv.py::takes_kernels). ``base_cfg``: the model
    configuration (default full-width SD1.5); its dtype and VAE sample size
    come from the flags. Returns (pipe, frozen, dcfg, state)."""
    from edgestyle_tpu_torch.apps.train import bf16_leaves, build_pipeline
    from edgestyle_tpu_torch.training.distill import init_distill_state

    pipe, gen, params = build_pipeline(args, device, base_cfg, fp32_weights=True,
                                       edgestyle_checkpoint=args.edgestyle_checkpoint)
    if pipe.dtype == torch.bfloat16:
        params = bf16_leaves(params, is_conv_kernel)
    frozen = {"vae": params["vae"], "clip": params["clip"], "unet": params["unet"],
              "static": params["controlnet"]["static"], "controlnet": params["controlnet"]}
    dcfg = distill_config(args)
    return pipe, frozen, dcfg, init_distill_state(pipe, gen, params["unet"], dcfg)


def main(argv=None, device="cuda", base_cfg=None):
    """Distil; print one JSON line every ``--logging_steps`` and a final one.
    Returns {'state', 'frozen', 'log'}: the final distill state, the frozen
    weights it distilled against and the logged metrics. ``device`` and
    ``base_cfg`` as :func:`build` takes them. Under torchrun the ranks
    distil data parallel, with apps/train.py::main's rules (the global
    micro-batch, each rank's rows, rank 0's output)."""
    from edgestyle_tpu_torch.apps.train import (
        check_supported,
        data_parallel,
        dataset_loader,
        rank_batch,
        summary_writer,
        synthetic_loader,
    )
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.core.mesh import DATA_AXIS, is_rank0, replicate_params
    from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids
    from edgestyle_tpu_torch.training.checkpoint import (
        export_safetensors,
        load_checkpoint,
        save_checkpoint,
    )
    from edgestyle_tpu_torch.training.distill import make_distill_step, sample_distill_draws

    args = parse_args(argv)
    check_supported(args)
    device, mesh = data_parallel(device)
    pipe, frozen, dcfg, state = build(args, device, base_cfg)
    step_fn = make_distill_step(
        pipe, dcfg, data_group=None if mesh is None else mesh.get_group(DATA_AXIS))
    if args.resume_from_checkpoint:
        state = load_checkpoint(args.output_dir, args.resume_from_checkpoint
                                if args.resume_from_checkpoint == "latest"
                                else int(args.resume_from_checkpoint), pipe.device)
    if mesh is not None:
        replicate_params(mesh, state)
    ids = torch.from_numpy(empty_prompt_ids(1, pipe.cfg.clip.max_positions)).long()
    with torch.no_grad():
        uncond_ctx = pipe.clip(frozen["clip"], ids.to(pipe.device))["last_hidden_state"]
    draw_gen = make_generator(args.seed + 1, pipe.device)
    loader = dataset_loader(args) if args.dataset_dir else synthetic_loader(args)
    if args.dataloader_num_workers > 0:
        from edgestyle_tpu_torch.data.prefetch import prefetch

        loader = prefetch(loader, depth=2)
    rank0 = is_rank0()
    writer = summary_writer(args) if rank0 else None
    log = []
    t0 = time.time()
    try:
        for batch in loader:
            if state["step"] >= args.max_train_steps:
                break
            batch, draws = rank_batch(mesh, batch,
                                      sample_distill_draws(pipe, dcfg, batch, draw_gen))
            state, metrics = step_fn(state, frozen, batch, uncond_ctx, draws)
            gstep = state["step"]
            if gstep % args.logging_steps == 0:
                rec = {"step": gstep, "loss": float(metrics["loss"]),
                       "elapsed_s": round(time.time() - t0, 3)}
                log.append(rec)
                if rank0:
                    print(json.dumps(rec), flush=True)
                if writer is not None:
                    writer.add_scalar("distill_loss", rec["loss"], gstep)
            if args.checkpointing_steps and gstep % args.checkpointing_steps == 0:
                save_checkpoint(args.output_dir, state, args.checkpoints_total_limit)
    finally:
        if hasattr(loader, "close"):
            loader.close()  # stops the prefetch thread (the source is infinite)
        if writer is not None:
            writer.close()
    save_checkpoint(args.output_dir, state, args.checkpoints_total_limit)
    # the serving artifact: the adapters alone, merged at load by --lcm_lora
    export_safetensors(os.path.join(args.output_dir, "lcm_lora.safetensors"),
                       {"lcm_lora": state["lcm_lora"]})
    if rank0:
        print(json.dumps({"done": True, "final_step": state["step"]}), flush=True)
    return {"state": state, "frozen": frozen, "log": log}


if __name__ == "__main__":
    main()

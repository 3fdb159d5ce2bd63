"""Deployment-export CLI.

Counterpart of edgestyle_tpu/apps/export.py (the reference's
export_onnx.py: UNet + MultiControlNet as one graph, a FLOP count, a parity
assert against the reloaded graph, the VAE encoder and decoder as graphs of
their own). Each artifact is a ``torch.export`` program of the port's own
functions (core/export.py), traced with the parameters as an argument (the
part of them each stage reads, pipelines/artifact.py::stage_params), so the
files hold no weights, saved, reloaded and held to the live function on the
example inputs:

* ``unet_controlnet.pt2``: one denoise step, the 6-branch MultiControlNet,
  the UNet with the injected residuals and the CFG combine
  (``EdgeStylePipeline._eval_step``, the live pipeline's own step);
* ``text_encoder.pt2`` (``encode_prompt``) and ``cond_embed.pt2``
  (``embed_cond_images``, CFG-doubled);
* ``vae_encoder.pt2`` (a posterior sample from noise the caller draws) and
  ``vae_decoder.pt2`` (latents to [0, 1] images);
* ``generate.pt2`` and ``serving.json`` (``--what generate``): the whole
  generation, ``EdgeStylePipeline.__call__`` with the serving knobs baked
  in and recorded;
* ``flops.json``: each program's FLOPs (core/export.py::flop_report).

int8 and int8-static (``--quant``) bake ops/quant.py's W8A8 path into the
denoise step (int8-static calibrates first, as the JAX CLI does); ``--tome``
bakes ToMe. pipelines/artifact.py serves both artifact shapes, and the
try-on CLI and the server take them with ``--exported_dir``.

    python -m edgestyle_tpu_torch.apps.export --random_init --output_dir out/export
    python -m edgestyle_tpu_torch.apps.export --random_init --output_dir out/aggr \\
        --what generate --mode aggressive
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from edgestyle_tpu_torch.apps.tryon import add_serving_args, apply_serving_mode
from edgestyle_tpu_torch.core.device import DeviceLike, make_generator, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle deployment export (PyTorch/CUDA)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--pretrained_model", type=str, default=None)
    p.add_argument("--vae", type=str, default=None)
    p.add_argument("--openpose_controlnet", type=str, default=None)
    p.add_argument("--edgestyle_checkpoint", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--what", choices=("all", "unet_controlnet", "vae", "text_cond", "generate"),
                   default="all",
                   help="'generate' exports the whole generation as one program, with the "
                        "serving knobs baked in and recorded in serving.json")
    p.add_argument("--batch", type=int, default=1,
                   help="logical batch; the denoise graph takes 2B rows (CFG)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--guidance", type=float, default=3.5)
    add_serving_args(p)
    p.add_argument("--steps", type=int, default=None,
                   help="denoise steps baked into the generate program (default 20; "
                        "--mode lcm: 4)")
    p.add_argument("--scheduler", type=str, default=None, choices=("unipc", "dpm++", "lcm"),
                   help="sampler baked into the generate program")
    p.add_argument("--quant", choices=("none", "int8", "int8-static"), default="none",
                   help="bake the W8A8 int8 denoise path (ops/quant.py) into the denoise "
                        "and generate programs; int8-static calibrates first")
    return apply_serving_mode(p.parse_args(argv))


def main(argv=None, config=None, device: DeviceLike = "cuda"):
    """Export what ``--what`` names into ``--output_dir``; returns the report
    written to flops.json: for each program its FLOPs and, under
    ``"export"``, its trace, save and reload seconds, its file's bytes and
    the reloaded program's measured parity with the live function."""
    from edgestyle_tpu_torch.core.export import export_program, flop_report
    from edgestyle_tpu_torch.ops.quant import quantize_denoise_params, quantize_intercept
    from edgestyle_tpu_torch.pipelines.artifact import stage_params
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

    args = parse_args(argv)
    dev = resolve_device(device)
    cfg = config or PipelineConfig(dtype=args.dtype, scheduler=args.scheduler)
    if config is not None and args.scheduler != "unipc":
        cfg = dataclasses.replace(cfg, scheduler=args.scheduler)
    pipe = EdgeStylePipeline(cfg, device=dev, tome=args.tome or None, quant=args.quant)
    if args.random_init:
        params = pipe.init_params(make_generator(0, dev))
    else:
        from edgestyle_tpu_torch.core.pretrained import load_pipeline_params

        params = load_pipeline_params(
            args.pretrained_model, args.vae, args.openpose_controlnet,
            edgestyle_checkpoint=args.edgestyle_checkpoint, pipe=pipe,
            generator=make_generator(0, dev))

    os.makedirs(args.output_dir, exist_ok=True)
    # The JAX CLI's tolerances: fp32 exact-grade; at bf16 its reloaded
    # program recompiles with another fusion order. Here the reloaded graph
    # runs the same operators and kernels on the same inputs, so the
    # measured share outside is reported beside the bound (0 expected).
    if cfg.dtype == "bfloat16":
        tol = {"rtol": 5e-2, "atol": 5e-2, "max_violation_frac": 0.05}
    else:
        tol = {"rtol": 1e-3, "atol": 1e-5}
    b = args.batch
    size = cfg.vae.sample_size
    hw = size // pipe.vae_downscale
    n_br = cfg.num_branches
    f32 = torch.float32
    rng = np.random.default_rng(0)
    report = {}

    def rand(shape, dtype=pipe.dtype):
        t = torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))
        t = t.to(dev, dtype)
        return t.contiguous(memory_format=torch.channels_last) if t.ndim == 4 else t

    def ids_like():
        return torch.from_numpy(rng.integers(1, cfg.clip.vocab_size,
                                             (b, cfg.clip.max_positions))).to(dev)

    def export(name, fn, ex, **kw):
        ex = (stage_params(name, ex[0]), *ex[1:])
        path = os.path.join(args.output_dir, f"{name}.pt2")
        stats = export_program(fn, ex, path, **(kw or tol))
        report[name] = dict(flop_report(fn, *ex), export=stats)
        print(f"exported {path}")

    if args.what in ("all", "unet_controlnet"):
        int8 = args.quant != "none"
        quant_scales = None
        if args.quant == "int8-static":
            # calibrate on random conditioning through the serving pipeline's
            # own machinery (the JAX CLI's recipe)
            qpipe = EdgeStylePipeline(cfg, device=dev, quant="int8-static")
            ids = ids_like()
            qpipe.calibrate_int8(params, ids, ids, [rand((b, 3, size, size), f32)
                                                    for _ in range(n_br)])
            quant_scales = qpipe._quant_scales_static()
        ones = np.ones((n_br,), np.float32)

        def denoise_step(p, sample, t, context, embs, guidance):
            if int8:
                p = quantize_denoise_params(p)
            with quantize_intercept(int8, static_scales=quant_scales):
                return pipe._eval_step(True, p, context, None, embs, ones, guidance, b, False,
                                       sample, t)

        # the context and embeddings as the live encoders give them (types
        # and layouts: the ControlLoRA branches' embeddings are fp32)
        with torch.no_grad():
            ids = ids_like()
            context = pipe.encode_prompt(params, ids, ids)
            embs = [torch.cat([e, e]) for e in pipe.embed_cond_images(
                params, [rand((b, 3, size, size), f32) for _ in range(n_br)])]
        ex = (params, rand((b, cfg.unet.in_channels, hw, hw), f32),
              torch.tensor(500, dtype=torch.long, device=dev), context, embs,
              torch.tensor(args.guidance, dtype=f32, device=dev))
        export("unet_controlnet", denoise_step, ex)

    if args.what in ("all", "text_cond"):
        def encode_text(p, ids, neg):
            return pipe.encode_prompt(p, ids, neg)

        def embed_conds(p, images):
            # posterior mode, CFG-doubled, as the pipeline's _generate
            return [torch.cat([e, e]) for e in pipe.embed_cond_images(p, images)]

        ids = torch.ones((b, cfg.clip.max_positions), dtype=torch.long, device=dev)
        export("text_encoder", encode_text, (params, ids, ids))
        export("cond_embed", embed_conds,
               (params, [rand((b, 3, size, size), f32) for _ in range(n_br)]))

    if args.what in ("all", "vae"):
        def encode(p, img, noise):
            mean, logvar = pipe.vae.encode_moments(p["vae"], img)
            return (mean + torch.exp(0.5 * logvar) * noise) * cfg.vae.scaling_factor

        def decode(p, lat):
            img = pipe.vae.decode(p["vae"], lat / cfg.vae.scaling_factor)
            return torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)

        export("vae_encoder", encode, (params, rand((b, 3, size, size), f32),
                                       rand((b, cfg.vae.latent_channels, hw, hw))))
        # the sampler hands the decoder fp32 latents
        export("vae_decoder", decode, (params, rand((b, cfg.unet.in_channels, hw, hw), f32)))

    if args.what == "generate":
        ids_ex = ids_like()
        imgs_ex = [rand((b, 3, size, size), f32) for _ in range(n_br)]
        if args.quant == "int8-static":
            # calibrate before the trace: the lazy calibration reads scales
            # back to the host
            pipe.calibrate_int8(params, ids_ex, ids_ex, imgs_ex)
        knobs = dict(
            num_inference_steps=args.steps,
            cfg_interval=tuple(args.cfg_interval),
            controlnet_cache_interval=args.controlnet_cache_interval,
            unet_cache_interval=args.unet_cache_interval,
            controlnet_cache_steps=(tuple(args.controlnet_cache_steps)
                                    if args.controlnet_cache_steps is not None else None),
            unet_cache_steps=(tuple(args.unet_cache_steps)
                              if args.unet_cache_steps is not None else None),
        )
        lcm = cfg.scheduler == "lcm"

        def generate(p, ids, neg, imgs, latents, renoise, guidance):
            return pipe(p, ids, neg, list(imgs), latents=latents, guidance_scale=guidance,
                        lcm_noise=list(renoise) if lcm else None, **knobs)

        gen = make_generator(0, dev)
        shape = (b, cfg.unet.in_channels, hw, hw)
        draw = lambda: torch.randn(shape, generator=gen, device=dev, dtype=f32)  # noqa: E731
        latents = draw().contiguous(memory_format=torch.channels_last)
        renoise = [draw() for _ in range(args.steps - 1)] if lcm else []
        ex = (params, ids_ex, ids_ex, imgs_ex, latents, renoise,
              torch.tensor(args.guidance, dtype=f32, device=dev))
        # at bf16 the JAX CLI holds the generated images, where per-step
        # differences compound, to a looser bound
        gtol = tol if cfg.dtype == "float32" else {
            "rtol": 0.1, "atol": 0.1, "max_violation_frac": 0.10}
        export("generate", generate, ex, **gtol)
        with open(os.path.join(args.output_dir, "serving.json"), "w") as f:
            json.dump(dict(knobs, mode=args.mode, scheduler=args.scheduler, batch=b,
                           dtype=args.dtype, quant=args.quant, tome=args.tome,
                           guidance_default=args.guidance), f, indent=2)
        print(f"exported generate (mode={args.mode}, knobs={knobs})")

    with open(os.path.join(args.output_dir, "flops.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v.get("flops") for k, v in report.items()}))
    return report


if __name__ == "__main__":
    main()

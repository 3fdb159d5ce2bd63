"""Try-on generation from precomputed conditioning images, on one card.

Counterpart of edgestyle_tpu/apps/infer.py (the reference's
test_text2image_pretrained_openpose.py: a batch demo with a guidance
sweep), with its flag set, aliases and defaults (:func:`parse_args`). The
six conditioning images come from the reference's artifact directories
(``--source_path`` ... ``<path>/{head or agnostic, openpose, clothes,
subject}/<name>``) or one flag per slot, a missing slot reading as zeros;
the prompt is ``--prompt``, or with ``--tokenizer_dir`` and
``--clip_model`` (a CLIPModel safetensors directory) mined from the
clothes image by CLIP, plus ``--prompt_text_to_add``. Every weight is held
in bf16 (norms too), as in the JAX app. ``--guidance_sweep`` writes the
reference's 3 x 3 grid: the three source photos and six generations over
guidance 1 -> 7 (nine generations without an artifact directory).

    python -m edgestyle_tpu_torch.apps.infer --random_init \\
        --source_path subj --source_image_name 0.jpg --target_path c1 \\
        --target_image_name 0.jpg --target_path2 c2 --target_image_name2 0.jpg \\
        --out result.png
    python -m edgestyle_tpu_torch.apps.infer --pretrained_model rv51 --vae sd-vae-ft-mse \\
        --openpose_controlnet openpose --edgestyle_checkpoint trained \\
        --agnostic a.png --original_openpose op.png --clothes c1.png \\
        --clothes_openpose cop1.png --clothes2 c2.png --clothes_openpose2 cop2.png \\
        --guidance_sweep --result_path results --image_result_name grid.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike

SLOTS = ("agnostic", "original_openpose", "clothes", "clothes_openpose", "clothes2",
         "clothes_openpose2")
SLOT_NORM = (True, False, True, False, True, False)  # VAE slots in [-1, 1], poses in [0, 1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle try-on inference (PyTorch/CUDA)")
    # the reference's flag names (test_text2image_pretrained_openpose.py's
    # ..._name_or_path) are aliases of the short names
    p.add_argument("--pretrained_model", "--pretrained_model_name_or_path",
                   type=str, default=None, dest="pretrained_model")
    p.add_argument("--vae", "--pretrained_vae_name_or_path", type=str, default=None, dest="vae")
    p.add_argument("--openpose_controlnet", "--pretrained_openpose_name_or_path",
                   type=str, default=None, dest="openpose_controlnet")
    p.add_argument("--edgestyle_checkpoint", "--controlnet_model_name_or_path",
                   type=str, default=None, dest="edgestyle_checkpoint",
                   help="trained trainable set: safetensors file or reference-layout dir")
    p.add_argument("--tokenizer_dir", type=str, default=None,
                   help="dir with vocab.json + merges.txt")
    p.add_argument("--clip_model", type=str, default=None,
                   help="full CLIPModel dir; with --tokenizer_dir mines the prompt from the "
                        "clothes image (the reference test script's best_embeddings)")
    p.add_argument("--random_init", action="store_true")
    # the reference's artifact-dir addressing:
    # <path>/{subject,agnostic,head,openpose,clothes}/<image_name>
    p.add_argument("--source_path", type=str, default=None)
    p.add_argument("--source_image_name", type=str, default=None)
    p.add_argument("--target_path", type=str, default=None)
    p.add_argument("--target_image_name", type=str, default=None)
    p.add_argument("--target_path2", type=str, default=None)
    p.add_argument("--target_image_name2", type=str, default=None)
    p.add_argument("--result_path", type=str, default=None)
    p.add_argument("--image_result_name", type=str, default=None)
    p.add_argument("--use_agnostic_images", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="branch 0 reads <source_path>/agnostic instead of /head (the "
                        "reference's default: head)")
    p.add_argument("--prompt_text_to_add", type=str, default="",
                   help="appended to the mined prompt")
    for f in SLOTS:
        p.add_argument(f"--{f}", type=str, default=None)
    p.add_argument("--prompt", type=str, default="edgestyle")
    p.add_argument("--negative_prompt", type=str,
                   default="monochrome, lowres, bad anatomy, worst quality, low quality")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--guidance", type=float, default=3.5)
    p.add_argument("--guidance_sweep", action="store_true",
                   help="3x3 grid over guidance 1.0 -> 7.0, as the reference test script")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--guess_mode", action="store_true",
                   help="the ControlNets see only the conditional batch, with a 0.1 -> 1.0 "
                        "residual ramp")
    p.add_argument("--control_guidance_start", type=float, default=0.0)
    p.add_argument("--control_guidance_end", type=float, default=1.0)
    p.add_argument("--scheduler", type=str, default="unipc", choices=("unipc", "dpm++"),
                   help="denoise sampler: unipc (the reference app's) or dpm++ "
                        "(DPM-Solver++ 2M)")
    p.add_argument("--out", type=str, default="result.png")
    return p.parse_args(argv)


def resolve_artifact_paths(args):
    """The reference's artifact-dir addressing -> (six slot paths, three
    source paths). Slot order: [agnostic-or-head, source pose, clothes1,
    pose1, clothes2, pose2]; sources: [subject, target, target2]."""
    def art(base, sub, name):
        return os.path.join(base, sub, name)

    first_sub = "agnostic" if args.use_agnostic_images else "head"
    slot_paths = [
        art(args.source_path, first_sub, args.source_image_name),
        art(args.source_path, "openpose", args.source_image_name),
        art(args.target_path, "clothes", args.target_image_name),
        art(args.target_path, "openpose", args.target_image_name),
        art(args.target_path2, "clothes", args.target_image_name2),
        art(args.target_path2, "openpose", args.target_image_name2),
    ]
    source_paths = [art(b, "subject", n) for b, n in (
        (args.source_path, args.source_image_name), (args.target_path, args.target_image_name),
        (args.target_path2, args.target_image_name2))]
    return slot_paths, source_paths


def _load(path: str, norm: bool) -> np.ndarray:
    """An image file -> (1, 512, 512, 3) float32: shorter side to 512
    (nearest), centre crop, then [-1, 1] (``norm``) or [0, 1]."""
    from PIL import Image

    from edgestyle_tpu_torch.data.transforms import standard_image, to_float01, to_norm

    with Image.open(path) as im:
        arr = standard_image(np.asarray(im.convert("RGB")))
    return (to_norm(arr) if norm else to_float01(arr))[None]


def main(argv=None, device: DeviceLike = "cuda", base_cfg=None) -> np.ndarray:
    """Generate; write the image (or the sweep's grid) to ``--out`` (or
    ``--result_path/--image_result_name``) and return it, uint8 HWC.
    ``base_cfg``: the model configuration (default full-width SD1.5), run
    in bf16 with ``--scheduler``."""
    import dataclasses

    from edgestyle_tpu_torch.apps.train import bf16_leaves
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

    args = parse_args(argv)
    pipe = EdgeStylePipeline(dataclasses.replace(base_cfg or PipelineConfig(), dtype="bfloat16",
                                                 scheduler=args.scheduler), device=device)
    gen = make_generator(0, pipe.device)
    if args.random_init:
        params = pipe.init_params(gen)
    else:
        from edgestyle_tpu_torch.core.pretrained import load_pipeline_params

        params = load_pipeline_params(args.pretrained_model, args.vae, args.openpose_controlnet,
                                      edgestyle_checkpoint=args.edgestyle_checkpoint, pipe=pipe,
                                      generator=gen)
    # inference holds every weight in bf16, norms included, as the JAX app
    params = bf16_leaves(params)

    grid_sources = []  # [subject, target, target2]: the reference grid's first row
    if args.source_path:
        slot_paths, source_paths = resolve_artifact_paths(args)
        imgs = [_load(p, n) for p, n in zip(slot_paths, SLOT_NORM)]
        grid_sources = [_load(p, False)[0] for p in source_paths]
    else:
        imgs = [_load(getattr(args, f), n) if getattr(args, f)
                else np.zeros((1, 512, 512, 3), np.float32) for f, n in zip(SLOTS, SLOT_NORM)]

    if args.tokenizer_dir:
        from edgestyle_tpu_torch.data.tokenizer import CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained_dir(args.tokenizer_dir)
        prompt = args.prompt
        if args.clip_model:
            from edgestyle_tpu_torch.data.prompts import build_prompt_miner

            miner = build_prompt_miner(args.tokenizer_dir, args.clip_model, device=pipe.device)
            prompt = miner(imgs[2] / 2.0 + 0.5)[0]
            del miner
            print(f"mined prompt: {prompt}")
        ids = tok([" ".join(filter(None, [prompt or "", args.prompt_text_to_add]))])
        neg = tok([args.negative_prompt])
    else:
        from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids

        ids = neg = empty_prompt_ids()

    cond = [torch.from_numpy(np.ascontiguousarray(im.transpose(0, 3, 1, 2))) for im in imgs]

    def generate(guidance: float) -> np.ndarray:
        out = pipe(params, ids, neg, cond, generator=make_generator(args.seed, pipe.device),
                   num_inference_steps=args.steps, guidance_scale=guidance,
                   guess_mode=args.guess_mode,
                   control_guidance_start=args.control_guidance_start,
                   control_guidance_end=args.control_guidance_end)
        return out[0].float().permute(1, 2, 0).cpu().numpy()

    if args.guidance_sweep:
        # the reference grid: the 3 source photos and NUM_IMAGES = 6
        # generations over guidance 1 -> 7, 3 x 3; without source photos
        # all 9 tiles are generations
        tiles = list(grid_sources)
        tiles += [generate(float(g)) for g in np.linspace(1.0, 7.0, 6 if grid_sources else 9)]
        rows = [np.concatenate(tiles[i * 3:(i + 1) * 3], axis=1) for i in range(3)]
        arr = (np.concatenate(rows, axis=0) * 255).astype(np.uint8)
    else:
        arr = (generate(args.guidance) * 255).astype(np.uint8)
    from PIL import Image

    out_path = args.out
    if args.result_path:  # the reference's output addressing
        os.makedirs(args.result_path, exist_ok=True)
        out_path = os.path.join(args.result_path,
                                args.image_result_name or os.path.basename(args.out))
    Image.fromarray(arr).save(out_path)
    print(f"saved {out_path}")
    return arr


if __name__ == "__main__":
    main()

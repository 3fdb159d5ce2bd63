"""End-to-end try-on: photos -> conditioning images -> generation, on one card.

Counterpart of edgestyle_tpu/apps/tryon.py (the reference app's preprocess
and try_on callbacks, app.py:125-256, and inference.py's extract_images ->
pipeline flow): OpenPose keypoints -> skeleton renders -> SAM masks (one
image encoding per photo, the base decoder and four heads) -> gray
composites -> the 6-branch generation.

Ported: random-init weights, the pose and SAM checkpoints (``.pt``/``.pth``
state dicts: full, ``{"state_dict"}``-wrapped or decoder-only heads), the
tokenizer, ``--fused`` and the exact UniPC generation. Every flag that asks
for something not ported raises ``NotImplementedError`` naming its ROADMAP
item (:func:`refuse_unported`); none is ignored.

    python -m edgestyle_tpu_torch.apps.tryon --random_init \\
        --subject person.jpg --clothes1 donor1.jpg --clothes2 donor2.jpg --out result.png
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, make_generator, resolve_device
from edgestyle_tpu_torch.core.porting import load_state_dict, tree_from_flat
from edgestyle_tpu_torch.models.efficientvit.sam import SAM_L2, port_sam_state_dict
from edgestyle_tpu_torch.models.openpose import (
    BodyPoseNet,
    Peaks,
    assemble_people_host,
    filter_and_pick_largest,
    find_peaks,
    port_bodypose_state_dict,
    preprocess_for_openpose,
    render_pose,
    score_limb_candidates,
    smooth_heatmaps,
)
from edgestyle_tpu_torch.pipelines.preprocess import HEAD_NAMES, TryOnPreprocessor, copy_tree
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

ROADMAP_LOADERS = "ROADMAP.md Queue 1 item 1b"
ROADMAP_KNOBS = "ROADMAP.md Queue 1 item 12"
ROADMAP_MODELS = "ROADMAP.md Queue 1 item 14"
ROADMAP_APPS = "ROADMAP.md Queue 1 item 15"
SERVING_MODES = ("exact", "conservative", "quality", "aggressive", "turbo", "lcm")
CANVAS = 512  # pose renders and SAM run at the 512 px working size


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle end-to-end try-on (PyTorch/CUDA)")
    p.add_argument("--subject", type=str, required=True)
    p.add_argument("--clothes1", type=str, required=True)
    p.add_argument("--clothes2", type=str, required=True)
    # model sources (the reference's load surface, extract_dataset.py:44-58)
    p.add_argument("--pretrained_model", "--pretrained_model_name_or_path", type=str,
                   default=None, dest="pretrained_model")
    p.add_argument("--vae", "--pretrained_vae_name_or_path", type=str, default=None, dest="vae")
    p.add_argument("--openpose_controlnet", "--pretrained_openpose_name_or_path", type=str,
                   default=None, dest="openpose_controlnet")
    p.add_argument("--edgestyle_checkpoint", "--controlnet_model_name_or_path", type=str,
                   default=None, dest="edgestyle_checkpoint")
    p.add_argument("--sam_checkpoint", type=str, default=None,
                   help="base EfficientViT-SAM l2 state dict (.pt/.pth)")
    p.add_argument("--sam_subject", type=str, default=None,
                   help="finetuned subject-head state dict (full or decoder-only)")
    p.add_argument("--sam_agnostic", type=str, default=None)
    p.add_argument("--sam_clothes", type=str, default=None)
    p.add_argument("--sam_head", type=str, default=None)
    p.add_argument("--bodypose_checkpoint", type=str, default=None)
    p.add_argument("--exported_dir", type=str, default=None)
    p.add_argument("--int8_scales", type=str, default=None)
    p.add_argument("--scheduler", type=str, default=None, choices=("unipc", "dpm++", "lcm"))
    p.add_argument("--lcm_lora", type=str, default=None)
    p.add_argument("--tokenizer_dir", type=str, default=None)
    p.add_argument("--clip_model", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--prompt_text_to_add", type=str, default="")
    p.add_argument("--negative_prompt", type=str,
                   default="monochrome, lowres, bad anatomy, worst quality, low quality")
    p.add_argument("--use_agnostic_images", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--fused", action="store_true",
                   help="masks, pose renders and generation in one call (pipelines/full.py)")
    p.add_argument("--steps", type=int, default=None, help="denoise steps (default 20)")
    p.add_argument("--guidance", type=float, default=3.5)
    p.add_argument("--mode", type=str, default="exact", choices=SERVING_MODES)
    p.add_argument("--controlnet_cache_interval", type=int, default=None)
    p.add_argument("--unet_cache_interval", type=int, default=None)
    p.add_argument("--controlnet_cache_steps", type=int, nargs="+", default=None)
    p.add_argument("--unet_cache_steps", type=int, nargs="+", default=None)
    p.add_argument("--cfg_interval", type=float, nargs=2, default=None)
    p.add_argument("--tome", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="result.png")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for the first flag
    that asks for something this port does not carry yet. A knob set to its
    exact-semantics value (``--mode exact``, ``--tome 0``, an interval of 1,
    ``--cfg_interval 0 1``, ``--scheduler unipc``) asks for nothing."""
    def get(name):
        return getattr(args, name, None)

    knobs = {
        "--mode": get("mode") not in (None, "exact"),
        "--controlnet_cache_interval": get("controlnet_cache_interval") not in (None, 1),
        "--unet_cache_interval": get("unet_cache_interval") not in (None, 1),
        "--controlnet_cache_steps": get("controlnet_cache_steps") is not None,
        "--unet_cache_steps": get("unet_cache_steps") is not None,
        "--cfg_interval": get("cfg_interval") is not None
        and tuple(map(float, get("cfg_interval"))) != (0.0, 1.0),
        "--tome": get("tome") not in (None, 0.0),
        "--int8_scales": get("int8_scales") is not None,
        "--scheduler": get("scheduler") not in (None, "unipc"),
    }
    refused = [(flag, ROADMAP_KNOBS) for flag, asked in knobs.items() if asked]
    refused += [(f"--{n}", ROADMAP_MODELS) for n in ("lcm_lora", "clip_model") if get(n)]
    refused += [("--exported_dir", ROADMAP_APPS)] if get("exported_dir") else []
    refused += [(f"--{n}", ROADMAP_LOADERS) for n in
                ("pretrained_model", "vae", "openpose_controlnet", "edgestyle_checkpoint")
                if get(n)]
    refused += [(f"--{n} (.safetensors)", ROADMAP_LOADERS)
                for n in ("sam_checkpoint", "sam_subject", "sam_agnostic", "sam_clothes",
                          "sam_head", "bodypose_checkpoint")
                if str(get(n) or "").endswith(".safetensors")]
    if refused:
        flag, item = refused[0]
        raise NotImplementedError(f"{flag} is not ported yet ({item})")


def load_image_512(path: str) -> np.ndarray:
    """Load -> pad to a white square -> 512 nearest, as the reference's
    resize_image_by_padding (inference.py:450-459). PIL is imported here
    only."""
    from PIL import Image

    from edgestyle_tpu_torch.data.transforms import resize_nearest

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    h, w = arr.shape[:2]
    side = max(h, w)
    canvas = np.full((side, side, 3), 255, np.uint8)
    top, left = (side - h) // 2, (side - w) // 2
    canvas[top:top + h, left:left + w] = arr
    return resize_nearest(canvas, (CANVAS, CANVAS))


def _nchw(imgs01) -> torch.Tensor:
    """(B, H, W, 3) host array -> (B, 3, H, W) fp32 tensor (host)."""
    return torch.from_numpy(np.ascontiguousarray(imgs01, dtype=np.float32)).permute(0, 3, 1, 2)


def _hwc(t: torch.Tensor) -> np.ndarray:
    """(B, 3, H, W) tensor -> (B, H, W, 3) fp32 numpy."""
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


@torch.no_grad()
def decode_pose_batch(paf: torch.Tensor,
                      heat: torch.Tensor) -> Tuple[List[Optional[np.ndarray]], np.ndarray]:
    """The pose net's (B, 38, h, w) PAF and (B, 19, h, w) heatmaps -> (B
    (18, 2) keypoint arrays in CANVAS px or None, (B, CANVAS, CANVAS, 3)
    skeleton renders, zeros where no person): peaks and limb scores for
    the batch on its device, the person assembly of each image on the
    host, one render of the batch."""
    peaks = find_peaks(smooth_heatmaps(heat, 3.0))
    scores, ok = score_limb_candidates(paf, peaks)
    xy, score, valid = (t.cpu().numpy() for t in peaks)
    scores, ok = scores.cpu().numpy(), ok.cpu().numpy()
    hm = heat.shape[2]
    kps_px, kp01s, found = [], [], []
    for i in range(heat.shape[0]):
        people = assemble_people_host(
            Peaks(xy=xy[i:i + 1], score=score[i:i + 1], valid=valid[i:i + 1]),
            scores[i:i + 1], ok[i:i + 1])
        person = filter_and_pick_largest(people)
        if person is None:
            kps_px.append(None)
            kp01s.append(np.full((18, 2), np.nan, np.float32))
            found.append(False)
        else:
            kps_px.append(person["keypoints"] * (float(CANVAS) / hm))
            kp01s.append(np.asarray(person["keypoints"], np.float32) / hm)
            found.append(True)
    skels = _hwc(render_pose(torch.from_numpy(np.stack(kp01s)).to(heat.device),
                             (CANVAS, CANVAS)))
    skels[~np.asarray(found)] = 0.0
    return kps_px, skels


class TryOnSystem:
    """Pose, segmentation and generation together; params from a seed
    (``random_init``) or from the pose and SAM checkpoints in ``args``.

    ``pipe`` and ``gen_params`` may hand in a generation pipeline and its
    params (e.g. one already built); by default a full-width bf16 SD1.5
    pipeline is built and, with ``random_init``, initialised after the pose
    net and SAM from the same generator."""

    pose_size = 184  # the pose net's working scale (the original's 0.5 * 368)

    def __init__(self, seed: int = 0, random_init: bool = True, args=None,
                 device: DeviceLike = "cuda", pipe: Optional[EdgeStylePipeline] = None,
                 gen_params: Optional[Dict] = None):
        if args is not None:
            refuse_unported(args)
        self.device = resolve_device(device)
        self.use_agnostic = bool(getattr(args, "use_agnostic_images", False))
        self.pose_net = BodyPoseNet()
        self.preproc = TryOnPreprocessor(SAM_L2, dtype=torch.bfloat16)
        self.pipe = pipe if pipe is not None else EdgeStylePipeline(
            PipelineConfig(dtype="bfloat16"), device=self.device)
        self.gen_params = gen_params
        if random_init:
            gen = make_generator(seed, self.device)
            self.pose_params = self.pose_net.init_params(gen)
            self.sam_params = self.preproc.init_params(gen)
            if self.gen_params is None:
                self.gen_params = self.pipe.init_params(gen)
        else:
            if not (getattr(args, "bodypose_checkpoint", None)
                    and getattr(args, "sam_checkpoint", None)):
                raise ValueError("without --random_init, --bodypose_checkpoint and "
                                 "--sam_checkpoint are required")
            self.pose_params = tree_from_flat(
                port_bodypose_state_dict(load_state_dict(args.bodypose_checkpoint)), self.device)
            self.sam_params = _load_sam_params(self.preproc, args.sam_checkpoint,
                                               sam_head_paths(args), self.device)

    # -------------------------------------------------------------- pose
    def detect_pose(self, img01: np.ndarray) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """(H, W, 3) in [0, 1] -> (keypoints (18, 2) px or None, skeleton
        image (512, 512, 3))."""
        kps, skels = self.detect_pose_batch(np.asarray(img01)[None])
        return kps[0], skels[0]

    @torch.no_grad()
    def detect_pose_batch(self, imgs01) -> Tuple[List[Optional[np.ndarray]], np.ndarray]:
        """(B, H, W, 3) in [0, 1] -> (B (18, 2) px keypoint arrays or None,
        (B, 512, 512, 3) fp32 skeleton renders, zeros where no person):
        one pose-net call for the batch, the person assembly of each image
        on the host, one render of the batch."""
        x = preprocess_for_openpose(_nchw(imgs01).to(self.device), self.pose_size)
        paf, heat = self.pose_net(self.pose_params, x)
        return decode_pose_batch(paf, heat)

    # -------------------------------------------------------------- masks
    def extract(self, img01: np.ndarray, keypoints_px) -> Dict[str, np.ndarray]:
        out = self.extract_batch(np.asarray(img01)[None], [keypoints_px])
        return {k: v[0] if k != "subject_score" else float(v[0]) for k, v in out.items()}

    def extract_batch(self, imgs01, keypoints_px) -> Dict[str, np.ndarray]:
        """(B, H, W, 3) in [0, 1] and B (18, 2) px keypoint arrays (None =
        missing) -> batched (B, H, W, 3) composites and (B,) subject scores,
        from one preprocessing call."""
        kps = np.stack([np.asarray(k, np.float32) if k is not None
                        else np.full((18, 2), np.nan, np.float32) for k in keypoints_px])
        out = self.preproc(self.sam_params, _nchw(imgs01).to(self.device),
                           torch.from_numpy(kps).to(self.device))
        res = {k: _hwc(getattr(out, k)) for k in ("subject", "agnostic", "head", "clothes")}
        res["subject_score"] = out.subject_score.cpu().numpy()
        return res

    # ----------------------------------------------------------- generate
    def generate(self, cond: Dict[str, np.ndarray], prompt_ids, neg_ids, steps: int = 20,
                 guidance: float = 3.5, seed: int = 0) -> np.ndarray:
        """The six cond images (HWC in [0, 1]) -> the try-on image (H, W, 3)."""
        self._check_gen_params()
        to_norm = lambda a: _nchw(np.asarray(a)[None] * 2.0 - 1.0)  # noqa: E731
        to01 = lambda a: _nchw(np.asarray(a)[None])  # noqa: E731
        imgs = [to_norm(cond["agnostic"]), to01(cond["subject_pose"]),
                to_norm(cond["clothes1"]), to01(cond["clothes1_pose"]),
                to_norm(cond["clothes2"]), to01(cond["clothes2_pose"])]
        out = self.pipe(self.gen_params, prompt_ids, neg_ids, imgs,
                        generator=make_generator(seed, self.device), num_inference_steps=steps,
                        guidance_scale=guidance)
        return _hwc(out)[0]

    def _check_gen_params(self) -> None:
        if self.gen_params is None:
            raise ValueError(f"no generation weights: pass --random_init (pretrained weights "
                             f"wait for {ROADMAP_LOADERS})")

    def prepare_cond(self, subject01, clothes1_01, clothes2_01) -> Dict[str, np.ndarray]:
        """Photos -> the six-image cond dict (pose and SAM extraction)."""
        kp_s, pose_s = self.detect_pose(subject01)
        kp_1, pose_1 = self.detect_pose(clothes1_01)
        kp_2, pose_2 = self.detect_pose(clothes2_01)
        ex_s = self.extract(subject01, kp_s)
        ex_1 = self.extract(clothes1_01, kp_1)
        ex_2 = self.extract(clothes2_01, kp_2)
        return {
            "agnostic": ex_s["agnostic" if self.use_agnostic else "head"],
            "subject_pose": pose_s,
            "clothes1": ex_1["clothes"], "clothes1_pose": pose_1,
            "clothes2": ex_2["clothes"], "clothes2_pose": pose_2,
        }

    def prepare_cond_batch(self, subjects, clothes1s, clothes2s) -> List[Dict[str, np.ndarray]]:
        """B photo triples -> B cond dicts, per request what ``prepare_cond``
        gives, with all 3B photos through one pose-net call and one
        preprocessing call."""
        b = len(subjects)
        imgs = np.stack([np.asarray(a, np.float32) for a in (*subjects, *clothes1s, *clothes2s)])
        kps, skels = self.detect_pose_batch(imgs)
        ex = self.extract_batch(imgs, kps)
        key = "agnostic" if self.use_agnostic else "head"
        return [{
            "agnostic": ex[key][i], "subject_pose": skels[i],
            "clothes1": ex["clothes"][b + i], "clothes1_pose": skels[b + i],
            "clothes2": ex["clothes"][2 * b + i], "clothes2_pose": skels[2 * b + i],
        } for i in range(b)]

    def __call__(self, subject01, clothes1_01, clothes2_01, prompt_ids, neg_ids,
                 steps: int = 20, guidance: float = 3.5, seed: int = 0) -> np.ndarray:
        cond = self.prepare_cond(subject01, clothes1_01, clothes2_01)
        return self.generate(cond, prompt_ids, neg_ids, steps, guidance, seed)


def _load_sam_params(preproc: TryOnPreprocessor, base_path: str, head_paths=None,
                     device: DeviceLike = "cuda") -> Dict:
    """The base EfficientViT-SAM state dict and optional finetuned heads ->
    TryOnPreprocessor params (the reference's five-model load,
    extract_dataset.py:44-49). A head's state dict may be the full model's
    or its decoder's alone (segmenter_training_*.py:463); a head without a
    checkpoint copies the base decoder."""
    cfg = preproc.cfg
    base = tree_from_flat(port_sam_state_dict(load_state_dict(base_path), cfg), device)
    decoders = {}
    for name in HEAD_NAMES:
        path = (head_paths or {}).get(name)
        if not path:
            decoders[name] = copy_tree(base["mask_decoder"])
            continue
        sd = load_state_dict(path)
        if not any(k.startswith(("image_encoder.", "mask_decoder.")) for k in sd):
            sd = {"mask_decoder." + k: v for k, v in sd.items()}  # decoder-only
        decoders[name] = tree_from_flat(port_sam_state_dict(sd, cfg), device)["mask_decoder"]
    return {"sam": base, "decoders": decoders}


def sam_head_paths(args) -> dict:
    return {n: getattr(args, f"sam_{n}", None) for n in HEAD_NAMES}


def main(argv=None, device: DeviceLike = "cuda") -> np.ndarray:
    """Run the app; returns the try-on image (512, 512, 3) in [0, 1] and
    writes it to ``--out``."""
    args = parse_args(argv)
    system = TryOnSystem(random_init=args.random_init, args=args, device=device)
    subject, c1, c2 = (load_image_512(p).astype(np.float32) / 255.0
                       for p in (args.subject, args.clothes1, args.clothes2))

    if args.tokenizer_dir:
        from edgestyle_tpu_torch.data.tokenizer import CLIPTokenizer

        tok = CLIPTokenizer.from_pretrained_dir(args.tokenizer_dir)
        # the reference joins the prompt and its suffix with a space (:328)
        ids = tok([" ".join(filter(None, [args.prompt or "", args.prompt_text_to_add]))])
        neg = tok([args.negative_prompt])
    else:
        from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids

        ids = neg = empty_prompt_ids()
    steps = args.steps or 20

    if args.fused:
        from edgestyle_tpu_torch.pipelines.full import FusedTryOn

        system._check_gen_params()
        kps = []
        for img in (subject, c1, c2):
            kp, _ = system.detect_pose(img)
            kps.append(kp if kp is not None else np.full((18, 2), np.nan, np.float32))
        fused = FusedTryOn(system.preproc, system.pipe, use_agnostic=system.use_agnostic)
        params = {**system.sam_params, "gen": system.gen_params}
        photos = [_nchw(img[None])[0] for img in (subject, c1, c2)]
        out = _hwc(fused(params, *photos, np.stack(kps), ids, neg,
                         generator=make_generator(args.seed, system.device),
                         num_inference_steps=steps, guidance_scale=args.guidance))[0]
    else:
        out = system(subject, c1, c2, ids, neg, steps, args.guidance, args.seed)
    from PIL import Image

    Image.fromarray((out * 255).astype(np.uint8)).save(args.out)
    print(f"saved {args.out}")
    return out


if __name__ == "__main__":
    main()

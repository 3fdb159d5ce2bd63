"""End-to-end try-on: photos -> conditioning images -> generation, on one card.

Counterpart of edgestyle_tpu/apps/tryon.py (the reference app's preprocess
and try_on callbacks, app.py:125-256, and inference.py's extract_images ->
pipeline flow): OpenPose keypoints -> skeleton renders -> SAM masks (one
image encoding per photo, the base decoder and four heads) -> gray
composites -> the 6-branch generation.

Ported: random-init weights; the pose and SAM checkpoints (``.safetensors``
or ``.pt``/``.pth`` state dicts: full, ``{"state_dict"}``-wrapped or
decoder-only heads); the generation's weights from diffusers/HF
directories (``--pretrained_model`` with ``unet/`` and ``text_encoder/``,
``--vae``, ``--openpose_controlnet``) and the trained set
(``--edgestyle_checkpoint``: a reference-layout directory or an exported
file; core/pretrained.py); the tokenizer, ``--fused``; the serving knobs
(``--scheduler``, ``--tome``, ``--cfg_interval``, the cache flags) and
their ``--mode`` presets (:func:`apply_serving_mode`), ``--lcm_lora``
adapters merged into the UNet, and the prompt mined from the first garment
photo by CLIP (``--clip_model``, a CLIPModel safetensors directory, with
``--tokenizer_dir`` and no ``--prompt``; data/prompts.py), and W8A8 int8
serving (``EDGESTYLE_QUANT=int8`` or ``int8-static``, the latter with a
calibration table from ``--int8_scales`` or calibrated on the first
request). ``TryOnSystem.generate_batch`` runs several requests as one
generation (apps/serve.py's dynamic batching). ``--exported_dir`` generates
through apps/export.py's artifacts (pipelines/artifact.py::ArtifactPipeline:
the per-stage graphs, exact semantics only, or a whole-generation program
with its knobs baked in); with ``--random_init`` the weight flags are
ignored, as in the JAX app.

    python -m edgestyle_tpu_torch.apps.tryon --random_init \\
        --subject person.jpg --clothes1 donor1.jpg --clothes2 donor2.jpg --out result.png
    python -m edgestyle_tpu_torch.apps.tryon --random_init --mode turbo \\
        --subject person.jpg --clothes1 donor1.jpg --clothes2 donor2.jpg --out result.png
    python -m edgestyle_tpu_torch.apps.tryon --random_init --tokenizer_dir clip-tok \
        --clip_model clip-vit-large-patch14 \
        --subject person.jpg --clothes1 donor1.jpg --clothes2 donor2.jpg --out result.png
    python -m edgestyle_tpu_torch.apps.tryon --pretrained_model rv51 --vae sd-vae-ft-mse \\
        --openpose_controlnet openpose --edgestyle_checkpoint trained \\
        --sam_checkpoint l2.safetensors --bodypose_checkpoint body_pose.safetensors \\
        --subject person.jpg --clothes1 donor1.jpg --clothes2 donor2.jpg --out result.png
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, make_generator, resolve_device
from edgestyle_tpu_torch.core.porting import load_state_dict, tree_from_flat
from edgestyle_tpu_torch.core.pretrained import load_pipeline_params
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
from edgestyle_tpu_torch.pipelines.artifact import GENERATE_GRAPH, ArtifactPipeline
from edgestyle_tpu_torch.pipelines.preprocess import HEAD_NAMES, TryOnPreprocessor, copy_tree
from edgestyle_tpu_torch.pipelines.tryon import SCHEDULERS, EdgeStylePipeline, PipelineConfig
from edgestyle_tpu_torch.training.checkpoint import import_safetensors
from edgestyle_tpu_torch.training.distill import apply_lcm_lora

CANVAS = 512  # pose renders and SAM run at the 512 px working size

# The serving presets of the JAX app: named bundles of the opt-in
# approximation knobs; "exact" is the reference's semantics. A preset fills
# only the knobs the user left unset (the knob flags parse to None), so an
# explicit flag wins even at its exact value (``--mode turbo --tome 0``).
SERVING_MODES = {
    "exact": {},
    "conservative": {"tome": 0.5},
    "quality": {"controlnet_cache_interval": 2},
    # a front-loaded ControlNet refresh schedule (DeepCache's non-uniform
    # sampling), for the 20-step default
    "aggressive": {"controlnet_cache_steps": (0, 1, 2, 4, 7, 11, 16)},
    # a draft mode
    "turbo": {"cfg_interval": (0.0, 0.4), "controlnet_cache_interval": 3,
              "unet_cache_interval": 2, "tome": 0.5},
    # few-step consistency sampling for --lcm_lora adapters: guidance is
    # baked in at distillation, so CFG is off
    "lcm": {"cfg_interval": (0.0, 0.0), "scheduler": "lcm", "steps": 4},
}
_MODE_KNOB_DEFAULTS = {
    "cfg_interval": (0.0, 1.0),
    "controlnet_cache_interval": 1,
    "unet_cache_interval": 1,
    "tome": 0.0,
    "scheduler": "unipc",
    "steps": 20,
}


def apply_serving_mode(args):
    """Fold ``args.mode``'s preset into the knob attributes that are still
    None, then give every knob left unset its exact value. An explicit
    interval beats a preset's refresh schedule (the two are exclusive); at
    an explicit ``--steps`` a preset's schedule keeps only its in-range
    steps (a user's own schedule stays as given, and the pipeline checks
    it). Idempotent."""
    mode = getattr(args, "mode", None) or "exact"
    if mode not in SERVING_MODES:
        raise ValueError(f"unknown serving mode {mode!r} (choose from {sorted(SERVING_MODES)})")
    for knob, value in SERVING_MODES[mode].items():
        if knob in ("controlnet_cache_steps", "unet_cache_steps") and (
                getattr(args, knob.replace("_steps", "_interval"), None) is not None):
            continue
        if getattr(args, knob, None) is None:
            if knob in ("controlnet_cache_steps", "unet_cache_steps"):
                steps = getattr(args, "steps", None)
                if steps is not None:
                    value = tuple(s for s in value if s < steps)
            setattr(args, knob, value)
    for knob, default in _MODE_KNOB_DEFAULTS.items():
        if hasattr(args, knob) and getattr(args, knob) is None:
            setattr(args, knob, default)
    return args


def serving_kwargs(args) -> Dict:
    """The pipeline call's knob arguments from ``args`` (after
    :func:`apply_serving_mode`), without those at their exact value."""
    kw = {}
    for name in ("controlnet_cache_interval", "unet_cache_interval"):
        if int(getattr(args, name, None) or 1) > 1:
            kw[name] = int(getattr(args, name))
    for name in ("controlnet_cache_steps", "unet_cache_steps"):
        if getattr(args, name, None):
            kw[name] = tuple(int(s) for s in getattr(args, name))
    ci = getattr(args, "cfg_interval", None) or (0.0, 1.0)
    if (float(ci[0]), float(ci[1])) != (0.0, 1.0):
        kw["cfg_interval"] = (float(ci[0]), float(ci[1]))
    return kw


def add_model_source_args(p):
    """The checkpoint-source flags that the try-on and the server share (the
    reference's load surface, extract_dataset.py:44-58)."""
    p.add_argument("--pretrained_model", "--pretrained_model_name_or_path", type=str,
                   default=None, dest="pretrained_model")
    p.add_argument("--vae", "--pretrained_vae_name_or_path", type=str, default=None, dest="vae")
    p.add_argument("--openpose_controlnet", "--pretrained_openpose_name_or_path", type=str,
                   default=None, dest="openpose_controlnet")
    p.add_argument("--edgestyle_checkpoint", "--controlnet_model_name_or_path", type=str,
                   default=None, dest="edgestyle_checkpoint")
    p.add_argument("--sam_checkpoint", type=str, default=None,
                   help="base EfficientViT-SAM l2 state dict (.safetensors/.pt/.pth)")
    p.add_argument("--sam_subject", type=str, default=None,
                   help="finetuned subject-head state dict (full or decoder-only)")
    p.add_argument("--sam_agnostic", type=str, default=None)
    p.add_argument("--sam_clothes", type=str, default=None)
    p.add_argument("--sam_head", type=str, default=None)
    p.add_argument("--bodypose_checkpoint", type=str, default=None)
    p.add_argument("--exported_dir", type=str, default=None)
    p.add_argument("--int8_scales", type=str, default=None,
                   help="JSON calibration table for EDGESTYLE_QUANT=int8-static "
                        "(EdgeStylePipeline.save_int8_scales, either package's); skips the "
                        "first-request calibration")
    p.add_argument("--scheduler", type=str, default=None, choices=("unipc", "dpm++", "lcm"),
                   help="denoise sampler: unipc (the reference app's), dpm++ "
                        "(DPM-Solver++ 2M) or lcm (few-step, for --lcm_lora; pair it with "
                        "--cfg_interval 0 0)")
    p.add_argument("--lcm_lora", type=str, default=None,
                   help="LCM-LoRA adapters (a safetensors file whose 'lcm_lora' tree "
                        "training/checkpoint.py::import_safetensors reads) merged into "
                        "the UNet")
    return p


def add_serving_args(p):
    """The serving preset and the knob flags that override it."""
    p.add_argument("--mode", type=str, default="exact", choices=sorted(SERVING_MODES),
                   help="serving preset of the approximation knobs; a knob flag overrides "
                        "it; exact is the reference's semantics")
    p.add_argument("--controlnet_cache_interval", type=int, default=None)
    p.add_argument("--unet_cache_interval", type=int, default=None)
    p.add_argument("--controlnet_cache_steps", type=int, nargs="+", default=None)
    p.add_argument("--unet_cache_steps", type=int, nargs="+", default=None)
    p.add_argument("--cfg_interval", type=float, nargs=2, default=None)
    p.add_argument("--tome", type=float, default=None)
    return p


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle end-to-end try-on (PyTorch/CUDA)")
    p.add_argument("--subject", type=str, required=True)
    p.add_argument("--clothes1", type=str, required=True)
    p.add_argument("--clothes2", type=str, required=True)
    add_model_source_args(p)
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
    p.add_argument("--steps", type=int, default=None,
                   help="denoise steps (default 20; --mode lcm: 4)")
    p.add_argument("--guidance", type=float, default=3.5)
    add_serving_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="result.png")
    return p.parse_args(argv)


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
    (``random_init``) or from the checkpoints in ``args``: the pose and SAM
    weights are required, the generation's come from ``--pretrained_model``
    (with ``--vae``, ``--openpose_controlnet`` and an optional
    ``--edgestyle_checkpoint``) when it is given.

    ``pipe`` and ``gen_params`` may hand in a generation pipeline and its
    params (e.g. one already built); by default a full-width bf16 SD1.5
    pipeline is built, with ``args``' scheduler and ToMe ratio, and, with
    ``random_init``, initialised after the pose net and SAM from the same
    generator. ``args``' serving mode and knobs (:func:`apply_serving_mode`)
    go to every generation; ``--lcm_lora`` adapters are merged into the
    UNet. With ``--exported_dir`` the generation runs through an
    :class:`ArtifactPipeline` of that directory (``self.pipe``) on the
    weights laid out for the live pipeline; a serving knob then needs a
    whole-generation artifact, which checks it against what it bakes."""

    pose_size = 184  # the pose net's working scale (the original's 0.5 * 368)
    knobs: Dict = {}  # the pipeline call's serving knobs (serving_kwargs); {} is exact

    def __init__(self, seed: int = 0, random_init: bool = True, args=None,
                 device: DeviceLike = "cuda", pipe: Optional[EdgeStylePipeline] = None,
                 gen_params: Optional[Dict] = None):
        if args is not None:
            apply_serving_mode(args)
            self.knobs = serving_kwargs(args)
        self.device = resolve_device(device)
        self.use_agnostic = bool(getattr(args, "use_agnostic_images", False))
        self.pose_net = BodyPoseNet()
        self.preproc = TryOnPreprocessor(SAM_L2, dtype=torch.bfloat16)
        scheduler = getattr(args, "scheduler", None) or "unipc"
        tome = float(getattr(args, "tome", None) or 0.0)
        if pipe is None:
            pipe = EdgeStylePipeline(PipelineConfig(dtype="bfloat16", scheduler=scheduler),
                                     device=self.device, tome=tome)
        elif args is not None and (type(pipe.scheduler) is not SCHEDULERS[scheduler]
                                   or (pipe.tome.ratio if pipe.tome else 0.0) != tome):
            raise ValueError(f"the pipeline handed in does not run --scheduler {scheduler} "
                             f"--tome {tome}")
        self.pipe = pipe
        exported = getattr(args, "exported_dir", None)
        if exported:
            if (self.knobs or pipe.tome is not None) and not os.path.exists(
                    os.path.join(exported, GENERATE_GRAPH)):
                raise ValueError(
                    "--controlnet_cache_interval / --unet_cache_interval "
                    "> 1, --controlnet_cache_steps / --unet_cache_steps, "
                    "--cfg_interval and --tome need the live pipeline or a "
                    "one-program artifact (apps/export.py --what generate "
                    "--mode ...): the per-stage artifact path runs the "
                    "denoise step as a fixed exact-semantics graph")
            self.pipe = ArtifactPipeline(exported, scheduler=scheduler, device=self.device)
        self.gen_params = gen_params
        if random_init:
            gen = make_generator(seed, self.device)
            self.pose_params = self.pose_net.init_params(gen)
            self.sam_params = self.preproc.init_params(gen)
            if self.gen_params is None:
                self.gen_params = pipe.init_params(gen)
        else:
            if not (getattr(args, "bodypose_checkpoint", None)
                    and getattr(args, "sam_checkpoint", None)):
                raise ValueError("without --random_init, --bodypose_checkpoint and "
                                 "--sam_checkpoint are required")
            self.pose_params = tree_from_flat(port_bodypose_state_dict(
                load_state_dict(args.bodypose_checkpoint, self.device)), self.device)
            self.sam_params = _load_sam_params(self.preproc, args.sam_checkpoint,
                                               sam_head_paths(args), self.device)
            # generation weights are optional: extracting conditioning
            # images needs only the pose net and SAM
            if self.gen_params is None and getattr(args, "pretrained_model", None):
                self.gen_params = load_pipeline_params(
                    args.pretrained_model, args.vae, args.openpose_controlnet,
                    edgestyle_checkpoint=args.edgestyle_checkpoint, pipe=pipe,
                    generator=make_generator(seed, self.device))
        lcm_path = getattr(args, "lcm_lora", None)
        if lcm_path:
            self._check_gen_params()
            adapters = import_safetensors(lcm_path, self.device)["lcm_lora"]
            self.gen_params = dict(self.gen_params,
                                   unet=apply_lcm_lora(self.gen_params["unet"], adapters))
        elif scheduler == "lcm":
            warnings.warn("--scheduler lcm (or --mode lcm) without --lcm_lora: few-step "
                          "sampling of undistilled weights gives collapsed images; pass "
                          "distilled LCM-LoRA adapters for real serving", stacklevel=2)
        if getattr(args, "int8_scales", None):
            pipe.load_int8_scales(args.int8_scales)

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
        """The six cond images (HWC in [0, 1]) -> the try-on image (H, W, 3),
        through the live pipeline or the artifact."""
        return self._generate_rows([cond], prompt_ids, neg_ids, steps, guidance, (seed,))[0]

    def generate_batch(self, conds: List[Dict[str, np.ndarray]], prompt_ids, neg_ids,
                       steps: int = 20, guidance=3.5, seeds=(0,)) -> np.ndarray:
        """B requests as one generation: ``conds`` B cond dicts
        (:meth:`prepare_cond`), ids (B, 77), a guidance scalar or per-request
        list, one seed per request -> (B, H, W, 3). Each row's latents are
        its seed's generator's ``randn((1, 4, h, w))``, so each row computes
        what that request alone would, up to the batch's reduction order on
        the card. A single request's generator also feeds the LCM sampler's
        re-noise; a batch's re-noise starts from seed 0, as the JAX
        package's batched path. The live pipeline's alone: an artifact
        (``--exported_dir``) serves one request at a time."""
        if isinstance(self.pipe, ArtifactPipeline):
            raise ValueError(
                "batched generation needs the live pipeline: the artifact "
                "path (--exported_dir) supports neither explicit latents "
                "nor per-sample guidance")
        return self._generate_rows(conds, prompt_ids, neg_ids, steps, guidance, seeds)

    def _generate_rows(self, conds, prompt_ids, neg_ids, steps, guidance, seeds) -> np.ndarray:
        self._check_gen_params()
        if len(seeds) != len(conds):
            raise ValueError(f"{len(conds)} requests but {len(seeds)} seeds: one seed per "
                             f"request reproduces its single-request latents")
        stack = lambda k: np.stack([np.asarray(c[k]) for c in conds])  # noqa: E731
        imgs = [_nchw(stack(k) * 2.0 - 1.0) if k in ("agnostic", "clothes1", "clothes2")
                else _nchw(stack(k)) for k in ("agnostic", "subject_pose", "clothes1",
                                                 "clothes1_pose", "clothes2", "clothes2_pose")]
        if isinstance(self.pipe, ArtifactPipeline):
            shape = (1, *self.pipe.latent_shape[1:])
        else:
            ds = self.pipe.vae_downscale
            shape = (1, self.pipe.cfg.unet.in_channels, imgs[0].shape[2] // ds,
                     imgs[0].shape[3] // ds)
        gens = [make_generator(s, self.device) for s in seeds]
        lat = torch.cat([torch.randn(shape, generator=g, device=self.device,
                                     dtype=torch.float32) for g in gens])
        g = guidance if np.isscalar(guidance) else np.asarray(guidance, np.float32)
        out = self.pipe(self.gen_params, prompt_ids, neg_ids, imgs, latents=lat,
                        generator=gens[0] if len(gens) == 1 else None,
                        num_inference_steps=steps, guidance_scale=g, **self.knobs)
        return _hwc(out)

    def _check_gen_params(self) -> None:
        if self.gen_params is None:
            raise ValueError("no generation weights: pass --random_init, or --pretrained_model "
                             "with --vae and --openpose_controlnet")

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
    extract_dataset.py:44-49). A head without a checkpoint copies the base
    decoder. A head's file may be in either of two layouts:

      * torch's: the full model's state dict or its decoder's alone
        (``torch.save(mask_decoder.state_dict())``,
        segmenter_training_*.py:463), mapped by ``port_sam_state_dict``;
      * the Flax layout that either package's ``train_segmenter`` writes
        (``trained_decoder_<head>.safetensors``: ``hyper_mlps_0.layers_0.
        kernel``, ..., with or without a ``mask_decoder.`` prefix), known by
        its keys and converted by ``from_jax_params``."""
    cfg = preproc.cfg
    base = tree_from_flat(port_sam_state_dict(load_state_dict(base_path, device), cfg), device)
    decoders = {}
    for name in HEAD_NAMES:
        path = (head_paths or {}).get(name)
        if not path:
            decoders[name] = copy_tree(base["mask_decoder"])
            continue
        sd = load_state_dict(path, device)
        if _is_flax_decoder(sd):
            decoders[name] = _flax_decoder(sd, device)
            continue
        if not any(k.startswith(("image_encoder.", "mask_decoder.")) for k in sd):
            sd = {"mask_decoder." + k: v for k, v in sd.items()}  # decoder-only
        decoders[name] = tree_from_flat(port_sam_state_dict(sd, cfg), device)["mask_decoder"]
    return {"sam": base, "decoders": decoders}


def _is_flax_decoder(sd: Dict) -> bool:
    """A decoder in the Flax layout: its keys name Flax's ``hyper_mlps_<i>``,
    which torch's state dicts call ``output_hypernetworks_mlps.<i>``."""
    return any(".hyper_mlps_" in "." + k for k in sd)


def _flax_decoder(sd: Dict, device: DeviceLike) -> Dict:
    """A Flax-layout decoder state dict -> the port's decoder tree, fp32."""
    from edgestyle_tpu_torch.core.params import unflatten
    from edgestyle_tpu_torch.core.porting import from_jax_params

    flat = {tuple(k.removeprefix("mask_decoder.").split(".")): v.float().cpu().numpy()
            for k, v in sd.items()}
    return from_jax_params(unflatten(flat), device, torch.float32)


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
        prompt = args.prompt
        if prompt is None and args.clip_model:
            from edgestyle_tpu_torch.data.prompts import build_prompt_miner

            miner = build_prompt_miner(args.tokenizer_dir, args.clip_model, device=system.device)
            prompt = miner(c1[None])[0]
            del miner
            print(f"mined prompt: {prompt}")
        # the reference joins the prompt and its suffix with a space (:328)
        ids = tok([" ".join(filter(None, [prompt or "", args.prompt_text_to_add]))])
        neg = tok([args.negative_prompt])
    else:
        from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids

        ids = neg = empty_prompt_ids()
    steps = args.steps  # set by the serving mode: 20, or 4 for lcm

    if args.fused:
        from edgestyle_tpu_torch.pipelines.full import FusedTryOn

        if isinstance(system.pipe, ArtifactPipeline):
            raise ValueError("--fused runs the live pipeline's program; it takes no "
                             "--exported_dir")

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

"""OpenPose body estimation and skeleton rendering.

Counterpart of edgestyle_tpu/models/openpose.py (the reference's
controlnet_aux OpenposeDetector, extract_dataset.py:214-295):

  * the body CNN (a VGG trunk and six two-branch PAF/heatmap stages, the
    CMU body_pose_model) on the card, NCHW;
  * peak finding (4-neighbourhood local maxima above a threshold, top K per
    part) and the PAF line-integral scores of every candidate limb, on the
    card with fixed shapes;
  * the person assembly, a small irregular greedy merge, on the host in
    numpy (:func:`assemble_people_host`, :func:`filter_and_pick_largest`,
    copies of the JAX package's);
  * the skeleton render (capsule limbs and joint discs as distance fields),
    on the card for a batch of images at once.

COCO-18 keypoint order, as the reference documents (extract_dataset.py:196-213).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core.params import InitTree, materialize, param, sub
from edgestyle_tpu_torch.ops.resize import linear_resize

NUM_PARTS = 18  # +1 background heatmap channel
NUM_HEAT = 19
NUM_PAF = 38

# limb sequence (1-indexed in the original; here 0-indexed pairs)
LIMB_SEQ = [
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
    (2, 16), (5, 17),
]
# PAF channel pairs of each limb (0-indexed into the 38 channels)
MAP_IDX = [
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1), (2, 3),
    (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35), (32, 33),
    (36, 37), (18, 19), (26, 27),
]

POSE_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
]

TRUNK = [("conv1_1", 64), ("conv1_2", 64), "pool", ("conv2_1", 128), ("conv2_2", 128), "pool",
         ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), "pool",
         ("conv4_1", 512), ("conv4_2", 512), ("conv4_3_CPM", 256), ("conv4_4_CPM", 128)]
STAGE1 = ((128, 3), (128, 3), (128, 3), (512, 1))
STAGE_N = ((128, 7),) * 5 + ((128, 1),)


def _conv(p, x, ch: int, k: int, dtype) -> torch.Tensor:
    w = param(p, "kernel", (ch, x.shape[1], k, k))
    b = param(p, "bias", (ch,), "zeros")
    return F.conv2d(x.to(dtype), w.to(dtype), b.to(dtype), padding=k // 2)


def _conv_block(p, x, features, dtype) -> torch.Tensor:
    """Convs with relu between them, none after the last."""
    for i, (ch, k) in enumerate(features):
        x = _conv(sub(p, f"conv_{i}"), x, ch, k, dtype)
        if i < len(features) - 1:
            x = F.relu(x)
    return x


class BodyPoseNet:
    """CMU body_pose_model: VGG trunk -> stage 1 (3x3 branches) -> 5
    refinement stages (7x7 branches) over cat(paf, heat, features)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def __call__(self, p, x: torch.Tensor):
        """x: (B, 3, H, W) in [-0.5, 0.5], H and W multiples of 8 ->
        (paf (B, 38, H/8, W/8), heat (B, 19, H/8, W/8))."""
        dt = self.dtype
        for layer in TRUNK:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(_conv(sub(p, layer[0]), x, layer[1], 3, dt))
        feat = x
        paf = _conv_block(sub(p, "stage1_L1"), feat, STAGE1 + ((NUM_PAF, 1),), dt)
        heat = _conv_block(sub(p, "stage1_L2"), feat, STAGE1 + ((NUM_HEAT, 1),), dt)
        for s in range(2, 7):
            inp = torch.cat([paf, heat, feat], dim=1)
            paf = _conv_block(sub(p, f"stage{s}_L1"), inp, STAGE_N + ((NUM_PAF, 1),), dt)
            heat = _conv_block(sub(p, f"stage{s}_L2"), inp, STAGE_N + ((NUM_HEAT, 1),), dt)
        return paf, heat

    def init_params(self, generator: torch.Generator, size: int = 184) -> Dict:
        tree = InitTree()
        self(tree, torch.zeros((1, 3, size, size), device="meta"))
        return materialize(tree, generator, self.dtype)


def _bodypose_rules() -> List[Tuple[str, str]]:
    rules = []
    for name, _ in (t for t in TRUNK if t != "pool"):
        rules.append((rf"model0\.{name}\.(weight|bias)", name))
    for L in (1, 2):
        for i in range(1, 6):
            rules.append((rf"model1_{L}\.conv5_{i}_CPM_L{L}\.(weight|bias)",
                          f"stage1_L{L}.conv_{i - 1}"))
        for s in range(2, 7):
            for i in range(1, 8):
                rules.append((rf"model{s}_{L}\.Mconv{i}_stage{s}_L{L}\.(weight|bias)",
                              f"stage{s}_L{L}.conv_{i - 1}"))
    return [(pat, prefix + r".\1") for pat, prefix in rules]


def port_bodypose_state_dict(sd) -> Dict:
    """controlnet_aux/CMU ``body_pose_model.pth`` keys (``model0.conv1_1``,
    ``model1_1.conv5_1_CPM_L1``, ``model{s}_{L}.Mconv{i}_stage{s}_L{L}``) ->
    flat {dotted path: leaf} of the port's tree (torch layout unchanged;
    core/porting.py::tree_from_flat places it)."""
    from edgestyle_tpu_torch.core.porting import KeyMapper

    out = KeyMapper(_bodypose_rules()).apply(sd)
    return {k[:-len(".weight")] + ".kernel" if k.endswith(".weight") else k: v
            for k, v in out.items()}


# ----------------------------------------------------------------- decoding
@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_peaks: int = 8  # K peaks per part
    thre1: float = 0.1  # heatmap peak threshold
    thre2: float = 0.05  # PAF sample threshold
    num_samples: int = 10  # PAF line-integral samples


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def smooth_heatmaps(heat: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """Separable gaussian blur of (B, C, H, W) (scipy's gaussian_filter with
    edge padding), as two depthwise convs."""
    radius = int(3 * sigma + 0.5)
    k = _gaussian_kernel1d(sigma, radius, heat.device)
    c = heat.shape[1]
    x = F.pad(heat, (0, 0, radius, radius), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.pad(x, (radius, radius, 0, 0), mode="replicate")
    return F.conv2d(x, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


class Peaks(NamedTuple):
    xy: torch.Tensor  # (B, 18, K, 2) x, y in heatmap pixels
    score: torch.Tensor  # (B, 18, K)
    valid: torch.Tensor  # (B, 18, K) bool


def find_peaks(heat: torch.Tensor, cfg: DecodeConfig = DecodeConfig()) -> Peaks:
    """Local maxima (4-neighbourhood) above thre1, the top K of each part.
    Among equal scores the lower flat index comes first, as jax.lax.top_k
    orders them (a stable descending sort)."""
    hm = heat[:, :NUM_PARTS]
    b, c, h, w = hm.shape
    pad = F.pad(hm, (1, 1, 1, 1), value=-1e9)
    is_peak = ((hm >= pad[:, :, :-2, 1:-1]) & (hm >= pad[:, :, 2:, 1:-1])
               & (hm >= pad[:, :, 1:-1, :-2]) & (hm >= pad[:, :, 1:-1, 2:])
               & (hm > cfg.thre1))
    scores = torch.where(is_peak, hm, torch.full((), -1e9, device=hm.device))
    top, idx = torch.sort(scores.reshape(b, c, h * w), dim=-1, descending=True, stable=True)
    top, idx = top[..., :cfg.max_peaks], idx[..., :cfg.max_peaks]
    xy = torch.stack([(idx % w).float(), torch.div(idx, w, rounding_mode="floor").float()], -1)
    return Peaks(xy=xy, score=top, valid=top > cfg.thre1)


def score_limb_candidates(paf: torch.Tensor, peaks: Peaks,
                          cfg: DecodeConfig = DecodeConfig()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score all K x K candidate (part A -> part B) connections of the 19
    limbs: (scores (B, 19, K, K), ok (B, 19, K, K)), the PAF line integral
    plus the distance prior, and the original algorithm's criterion (>= 80%
    of samples above thre2 and a positive score with the prior)."""
    b, _, h, w = paf.shape
    dev = paf.device
    limb_a = torch.tensor([l[0] for l in LIMB_SEQ], device=dev)
    limb_b = torch.tensor([l[1] for l in LIMB_SEQ], device=dev)
    paf_x = torch.tensor([m[0] for m in MAP_IDX], device=dev)
    paf_y = torch.tensor([m[1] for m in MAP_IDX], device=dev)

    pa = peaks.xy[:, limb_a][:, :, :, None, :]  # (B, 19, K, 1, 2)
    pb = peaks.xy[:, limb_b][:, :, None, :, :]  # (B, 19, 1, K, 2)
    vec = pb - pa  # (B, 19, K, K, 2)
    norm = torch.sqrt(torch.sum(vec ** 2, dim=-1)) + 1e-8
    u = vec / norm[..., None]

    ts = torch.linspace(0.0, 1.0, cfg.num_samples, device=dev)
    pts = pa[..., None, :] + vec[..., None, :] * ts[:, None]  # (B, 19, K, K, S, 2)
    px = torch.clamp(torch.round(pts[..., 0]), 0, w - 1).long()
    py = torch.clamp(torch.round(pts[..., 1]), 0, h - 1).long()
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    vx = paf[bi, paf_x[None, :, None, None, None], py, px]
    vy = paf[bi, paf_y[None, :, None, None, None], py, px]
    dot = vx * u[..., None, 0] + vy * u[..., None, 1]  # (B, 19, K, K, S)
    mean_score = torch.mean(dot, dim=-1)
    prior = torch.clamp(0.5 * h / norm - 1.0, max=0.0)
    with_prior = mean_score + prior
    crit1 = torch.mean((dot > cfg.thre2).float(), dim=-1) > 0.8
    a_val = peaks.valid[:, limb_a][:, :, :, None]
    b_val = peaks.valid[:, limb_b][:, :, None, :]
    return with_prior, crit1 & (with_prior > 0) & a_val & b_val


def assemble_people_host(peaks: Peaks, limb_scores: np.ndarray, limb_ok: np.ndarray,
                         max_people: int = 10) -> List[dict]:
    """Greedy per-limb matching and subset merge (host numpy; the original
    algorithm on fixed-size candidate grids) of the first image of the
    batch. Returns people {keypoints (18, 2) float or nan, scores (18,),
    total_score, total_parts} in heatmap coordinates, best first."""
    xy = np.asarray(peaks.xy[0])
    kscore = np.asarray(peaks.score[0])
    valid = np.asarray(peaks.valid[0])
    K = xy.shape[1]
    peak_id = np.arange(NUM_PARTS * K).reshape(NUM_PARTS, K)

    connections = []  # per limb: (ia, ib, score)
    for l, (a, b) in enumerate(LIMB_SEQ):
        cand = [(limb_scores[0, l, i, j], i, j) for i in range(K) for j in range(K)
                if limb_ok[0, l, i, j]]
        cand.sort(reverse=True)
        used_a, used_b, conns = set(), set(), []
        for s, i, j in cand:
            if i not in used_a and j not in used_b:
                used_a.add(i)
                used_b.add(j)
                conns.append((i, j, float(s)))
        connections.append(conns)

    people: List[dict] = []
    for l, (a, b) in enumerate(LIMB_SEQ[:17]):  # the last 2 limbs are ear-shoulder extras
        for i, j, s in connections[l]:
            pa, pb = peak_id[a, i], peak_id[b, j]
            found = [p for p in people if p["parts"].get(a) == pa or p["parts"].get(b) == pb]
            if not found:
                people.append({"parts": {a: pa, b: pb}, "score": s + kscore[a, i] + kscore[b, j]})
            elif len(found) == 1:
                p = found[0]
                if p["parts"].get(b) is None:
                    p["parts"][b] = pb
                    p["score"] += s + kscore[b, j]
                elif p["parts"].get(a) is None:
                    p["parts"][a] = pa
                    p["score"] += s + kscore[a, i]
            else:
                p1, p2 = found[0], found[1]
                if not (set(p1["parts"]) & set(p2["parts"])):
                    p1["parts"].update(p2["parts"])
                    p1["score"] += p2["score"] + s
                    people.remove(p2)

    out = []
    for p in people:
        kp = np.full((NUM_PARTS, 2), np.nan, np.float32)
        ks = np.zeros(NUM_PARTS, np.float32)
        for part, pid in p["parts"].items():
            pi, ki = divmod(int(pid), K)
            if valid[pi, ki]:
                kp[part] = xy[pi, ki]
                ks[part] = kscore[pi, ki]
        out.append({"keypoints": kp, "scores": ks, "total_score": float(p["score"]),
                    "total_parts": int(np.isfinite(kp[:, 0]).sum())})
    out.sort(key=lambda q: q["total_score"], reverse=True)
    return out[:max_people]


def filter_and_pick_largest(people: List[dict]) -> Optional[dict]:
    """The reference's filters (extract_dataset.py:223-267): score > 10,
    more than 5 parts, head evidence, a shoulder and a hip; then the
    largest keypoint bounding box."""
    def has(p, idxs):
        return any(np.isfinite(p["keypoints"][i, 0]) for i in idxs)

    cands = [p for p in people
             if p["total_score"] > 10 and p["total_parts"] > 5
             and has(p, [0, 1, 14, 15, 16, 17]) and has(p, [2, 5]) and has(p, [8, 11])]
    if not cands:
        return None

    def area(p):
        k = p["keypoints"]
        fin = np.isfinite(k[:, 0])
        if fin.sum() < 2:
            return 0.0
        xs, ys = k[fin, 0], k[fin, 1]
        return float((xs.max() - xs.min()) * (ys.max() - ys.min()))

    return max(cands, key=area)


# ---------------------------------------------------------------- rendering
def render_pose(keypoints01: torch.Tensor, canvas_hw: Tuple[int, int] = (512, 512),
                stickwidth: float = 4.0, radius: float = 4.0) -> torch.Tensor:
    """Rasterise skeletons as the OpenPose conditioning image, a batch at once.

    keypoints01: (B, 18, 2) in [0, 1] image coords, NaN = missing. Returns
    (B, 3, H, W) fp32 in [0, 1] on black: limbs are capsules (distance to
    the segment < stickwidth) at 0.6 of their colour, joints full-colour
    discs, drawn in draw_bodypose's order (17 limbs, then 18 joints)."""
    h, w = canvas_hw
    b = keypoints01.shape[0]
    dev = keypoints01.device
    kp = keypoints01.float() * torch.tensor([w, h], dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    pix = torch.stack([xs, ys], dim=-1).float()  # (H, W, 2)
    canvas = torch.zeros((b, 3, h, w), dtype=torch.float32, device=dev)
    colors = torch.tensor(POSE_COLORS, dtype=torch.float32, device=dev) / 255.0
    finite = torch.isfinite(kp).all(dim=-1)  # (B, 18)
    kp = torch.nan_to_num(kp)

    for l, (a, c) in enumerate(LIMB_SEQ[:17]):
        pa = kp[:, a][:, None, None, :]  # (B, 1, 1, 2)
        ab = kp[:, c][:, None, None, :] - pa
        denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-6)
        t = torch.clamp(torch.sum((pix - pa) * ab, dim=-1) / denom, 0.0, 1.0)
        proj = pa + t[..., None] * ab
        d = torch.sqrt(torch.sum((pix - proj) ** 2, dim=-1))
        m = (d < stickwidth) & (finite[:, a] & finite[:, c])[:, None, None]
        canvas = torch.where(m[:, None], torch.maximum(canvas, colors[l][:, None, None] * 0.6),
                             canvas)
    for i in range(NUM_PARTS):
        d = torch.sqrt(torch.sum((pix - kp[:, i][:, None, None, :]) ** 2, dim=-1))
        m = (d < radius) & finite[:, i][:, None, None]
        canvas = torch.where(m[:, None], colors[i][:, None, None], canvas)
    return canvas


def preprocess_for_openpose(img01: torch.Tensor, target: int = 184) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> the detector's working scale (the original
    runs at 0.5 * 368 / H), padded to a multiple of 8, in [-0.5, 0.5]; the
    resize is jax.image.resize's antialiased bilinear."""
    t8 = (target + 7) // 8 * 8
    return linear_resize(img01, (t8, t8)) - 0.5

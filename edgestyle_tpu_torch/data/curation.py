"""Dataset curation tools: the reference's find_bad_examples.py (CLIP-IQA
triage of the worst images), find_similar_subjects.py (cross-subject CLIP
similarity), find_and_remove_missing_images.py (artifact-set integrity),
find_empty_dirs.sh, merge_two_subjects.py, inspect_dataset.py
(augmentation grids) and compare_safetensors.py (checkpoint diff).

Counterpart of edgestyle_tpu/data/curation.py, with its prompt banks, its
results and its CLI output. CLIP-IQA is the prompt-pair formulation
(torchmetrics' CLIPIQA): per pair, the softmax of 100 x the cosine
similarities of the image to the positive and the negative prompt, with a
fixed logit scale of 100 and not the model's; the score is the positive
prompt's probability averaged over the pairs. The towers are the port's
own (data/prompts.py::load_clip_towers).

    python -m edgestyle_tpu_torch.data.curation missing DATASET
    python -m edgestyle_tpu_torch.data.curation bad DATASET --tokenizer_dir T --clip_model C
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device
from edgestyle_tpu_torch.core.params import flatten

# generic CLIP-IQA prompt pairs (torchmetrics CLIPIQA built-ins)
IQA_PROMPT_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("Good photo.", "Bad photo."),
    ("Sharp photo.", "Blurry photo."),
    ("Sharp edges.", "Blurry edges."),
    ("High resolution photo.", "Low resolution photo."),
    ("Noise-free photo.", "Photo with noise."),
)

# the reference's extraction ranking uses prompts=("quality","sharpness")
# (extract_dataset.py:92), i.e. torchmetrics' first two built-in pairs
EXTRACTION_PROMPT_PAIRS = IQA_PROMPT_PAIRS[:2]

# the reference's committed find_bad_examples triage hunts MULTI-PERSON
# frames, not blur (find_bad_examples.py:22-35: low P("one"/"single")
# ranks worst)
BAD_EXAMPLE_PROMPT_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("one", "two"),
    ("single", "multiple"),
)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ClipIQA:
    """score(images01) in [0, 1]^B: the positive prompt's probability,
    averaged over the prompt pairs.

    encode_image_fn: (B, H, W, 3) images in [0, 1] -> (B, D) embeddings.
    encode_text_fn: (N, 77) int64 ids (host) -> (N, D) embeddings."""

    def __init__(self, tokenizer, encode_image_fn, encode_text_fn,
                 prompt_pairs: Sequence[Tuple[str, str]] = IQA_PROMPT_PAIRS):
        texts = [t for pair in prompt_pairs for t in pair]
        ids = torch.from_numpy(np.asarray(tokenizer(texts), np.int64))
        emb = _unit(encode_text_fn(ids).float())
        self.text_bank = emb.reshape(len(prompt_pairs), 2, -1)
        self.encode_image = encode_image_fn

    @torch.no_grad()
    def __call__(self, images01) -> torch.Tensor:
        img = _unit(self.encode_image(images01).float())
        logits = 100.0 * torch.einsum("bd,ptd->bpt", img, self.text_bank.to(img.device))
        probs = torch.softmax(logits, dim=-1)[..., 0]  # P(positive)
        return probs.mean(dim=-1)


def find_bad_examples(
    image_paths: Sequence[str], iqa: ClipIQA, load_fn: Callable, worst_k: int = 20,
    batch_size: int = 16,
) -> List[Tuple[str, float]]:
    """Rank images by CLIP-IQA ascending (reference find_bad_examples.py)."""
    scores = []
    for i in range(0, len(image_paths), batch_size):
        chunk = image_paths[i: i + batch_size]
        imgs = torch.from_numpy(np.stack([np.asarray(load_fn(p), np.float32) for p in chunk]))
        s = iqa(imgs).cpu().numpy()
        scores.extend(zip(chunk, s.tolist()))
    scores.sort(key=lambda t: t[1])
    return scores[:worst_k]


def find_similar_subjects(
    subject_embeddings: Dict[str, np.ndarray], threshold: float = 0.92
) -> List[Tuple[str, str, float]]:
    """Pairs of subjects whose mean CLIP embeddings are suspiciously close
    (reference find_similar_subjects.py:74-102)."""
    names = sorted(subject_embeddings)
    out = []
    for i, a in enumerate(names):
        ea = subject_embeddings[a] / np.linalg.norm(subject_embeddings[a])
        for b in names[i + 1:]:
            eb = subject_embeddings[b] / np.linalg.norm(subject_embeddings[b])
            sim = float(ea @ eb)
            if sim >= threshold:
                out.append((a, b, sim))
    return sorted(out, key=lambda t: -t[2])


ARTIFACTS = ("processed", "openpose", "subject", "agnostic", "head", "clothes")


def find_missing_artifacts(root: str, artifacts: Sequence[str] = ARTIFACTS):
    """Frames missing any artifact (reference
    find_and_remove_missing_images.py:18-81). Returns
    {(subject, frame): [missing artifacts]}."""
    missing: Dict[Tuple[str, str], List[str]] = {}
    for subject in sorted(os.listdir(root)):
        sdir = os.path.join(root, subject)
        if not os.path.isdir(sdir):
            continue
        frames = set()
        for a in artifacts:
            adir = os.path.join(sdir, a)
            if os.path.isdir(adir):
                frames |= {os.path.splitext(f)[0] for f in os.listdir(adir)}
        for f in sorted(frames):
            miss = [
                a for a in artifacts
                if not any(
                    os.path.exists(os.path.join(sdir, a, f + ext))
                    for ext in (".jpg", ".jpeg", ".png")
                )
            ]
            if miss:
                missing[(subject, f)] = miss
    return missing


def find_empty_dirs(root: str) -> List[str]:
    """Directories under root containing no files anywhere below them
    (reference find_empty_dirs.sh). Returns paths relative to root,
    deepest first, so callers can rmdir in order."""
    empty: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root, topdown=False):
        rel = os.path.relpath(dirpath, root)
        if rel == ".":
            continue
        sub_empty = {os.path.join(rel, d) for d in dirnames}
        if not filenames and sub_empty <= set(empty):
            empty.append(rel)
    return empty


def remove_incomplete_frames(root: str, artifacts: Sequence[str] = ARTIFACTS) -> int:
    """Delete every artifact of frames flagged by find_missing_artifacts."""
    removed = 0
    for (subject, frame), _ in find_missing_artifacts(root, artifacts).items():
        for a in artifacts:
            for ext in (".jpg", ".jpeg", ".png"):
                p = os.path.join(root, subject, a, frame + ext)
                if os.path.exists(p):
                    os.remove(p)
                    removed += 1
    return removed


def merge_subjects(root: str, src: str, dst: str, skip_marker: str = "_skip_") -> None:
    """Move src subject's frames into dst with a prefix, then mark src
    skipped (reference merge_two_subjects.py:72-88)."""
    sdir, ddir = os.path.join(root, src), os.path.join(root, dst)
    for a in os.listdir(sdir):
        adir = os.path.join(sdir, a)
        if not os.path.isdir(adir):
            continue
        tdir = os.path.join(ddir, a)
        os.makedirs(tdir, exist_ok=True)
        for f in os.listdir(adir):
            shutil.copy2(os.path.join(adir, f), os.path.join(tdir, f"{src}_{f}"))
    open(os.path.join(sdir, skip_marker), "w").close()


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def compare_param_trees(a, b, rtol: float = 0.0, atol: float = 0.0):
    """Per-leaf diff report of two checkpoints (reference
    compare_safetensors.py:63-89). Returns list of (path, max_abs_diff)."""
    fa, fb = ({".".join(k): v for k, v in flatten(t).items()} for t in (a, b))
    report = []
    for k in sorted(set(fa) | set(fb)):
        if k not in fa or k not in fb:
            report.append((k, float("inf")))
            continue
        va, vb = _host(fa[k]), _host(fb[k])
        if va.shape != vb.shape:
            report.append((k, float("inf")))
            continue
        diff = float(np.max(np.abs(va - vb))) if va.size else 0.0
        if not np.allclose(va, vb, rtol=rtol, atol=atol):
            report.append((k, diff))
    return report


def inspect_dataset_grid(examples, collate_fn, rng, out_path: str):
    """Render a collated, augmented batch to a JPEG contact sheet
    (reference inspect_dataset.py:174-219)."""
    from PIL import Image

    batch = collate_fn(examples, rng)
    rows = []
    for key in ("original", "agnostic", "clothes", "clothes2",
                "original_openpose", "clothes_openpose"):
        arr = batch[key]
        if arr.min() < 0:
            arr = arr / 2 + 0.5
        rows.append(np.concatenate(list(arr), axis=1))
    grid = (np.concatenate(rows, axis=0).clip(0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(grid).save(out_path)
    return out_path


# ---------------------------------------------------------------------------
# CLI: one entry point for the reference's standalone curation scripts


def _load01(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def _clip_encoders(tokenizer_dir: str, clip_model: str, device: DeviceLike = "cuda", **cfgs):
    """(tokenizer, encode_images01 -> emb, encode_ids -> emb) from an
    openai/clip-vit-large-patch14-layout directory, fp32 on ``device``
    (``cfgs``: ``text_cfg`` / ``vision_cfg`` for other tower sizes).
    encode_images01 takes (B, H, W, 3) images in [0, 1], host or device."""
    from edgestyle_tpu_torch.data.prompts import load_clip_towers
    from edgestyle_tpu_torch.models.clip_vision import clip_preprocess

    dev = resolve_device(device)
    tok, encode_px, encode_text = load_clip_towers(tokenizer_dir, clip_model, torch.float32,
                                                   dev, **cfgs)

    def encode_image(images01):
        x = torch.as_tensor(images01, dtype=torch.float32, device=dev)
        return encode_px(clip_preprocess(x.permute(0, 3, 1, 2)))

    return tok, encode_image, encode_text


def _image_paths(root: str):
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in (".jpg", ".jpeg", ".png"):
                out.append(os.path.join(dirpath, f))
    return out


def main(argv=None, device: DeviceLike = "cuda"):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m edgestyle_tpu_torch.data.curation",
        description="dataset curation tools (reference find_*/merge/"
                    "inspect/compare scripts)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("missing", help="report frames missing artifacts")
    sp.add_argument("root")

    sp = sub.add_parser("clean", help="DELETE all artifacts of incomplete frames")
    sp.add_argument("root")

    sp = sub.add_parser("empty-dirs", help="list (optionally remove) empty dirs")
    sp.add_argument("root")
    sp.add_argument("--remove", action="store_true")

    sp = sub.add_parser("merge", help="merge src subject into dst, mark src skipped")
    sp.add_argument("root")
    sp.add_argument("src")
    sp.add_argument("dst")

    sp = sub.add_parser("compare", help="diff two safetensors checkpoints")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--rtol", type=float, default=0.0)
    sp.add_argument("--atol", type=float, default=0.0)

    sp = sub.add_parser("bad", help="CLIP prompt-pair worst-image triage")
    sp.add_argument("root")
    sp.add_argument("--tokenizer_dir", required=True)
    sp.add_argument("--clip_model", required=True)
    sp.add_argument("--worst_k", type=int, default=20)
    sp.add_argument("--pairs", nargs="+", default=None, metavar="POS|NEG",
                    help="prompt pairs 'positive|negative'; default is the "
                         "reference's multi-person hunt (one|two, "
                         "single|multiple); pass --pairs generic for the "
                         "quality/sharpness set")

    sp = sub.add_parser("similar", help="suspiciously-similar subject pairs")
    sp.add_argument("root")
    sp.add_argument("--tokenizer_dir", required=True)
    sp.add_argument("--clip_model", required=True)
    sp.add_argument("--threshold", type=float, default=0.92)
    sp.add_argument("--per_subject", type=int, default=8,
                    help="frames averaged per subject embedding")

    sp = sub.add_parser("inspect", help="render an augmented batch grid")
    sp.add_argument("root")
    sp.add_argument("--out", default="inspect_grid.jpg")
    sp.add_argument("--n", type=int, default=4)
    sp.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)

    if args.cmd == "missing":
        miss = find_missing_artifacts(args.root)
        for (subject, frame), arts in sorted(miss.items()):
            print(f"{subject}/{frame}: missing {', '.join(arts)}")
        print(f"{len(miss)} incomplete frames")
    elif args.cmd == "clean":
        print(f"removed {remove_incomplete_frames(args.root)} files")
    elif args.cmd == "empty-dirs":
        for rel in find_empty_dirs(args.root):
            print(rel)
            if args.remove:
                os.rmdir(os.path.join(args.root, rel))
    elif args.cmd == "merge":
        merge_subjects(args.root, args.src, args.dst)
        print(f"merged {args.src} -> {args.dst}")
    elif args.cmd == "compare":
        from edgestyle_tpu_torch.core.safetensors import load_file

        report = compare_param_trees(load_file(args.a), load_file(args.b),
                                     rtol=args.rtol, atol=args.atol)
        for key, diff in report:
            print(f"{key}: max_abs_diff={diff:.3e}")
        print(f"{len(report)} differing tensors")
    elif args.cmd == "bad":
        if args.pairs is None:
            pairs = BAD_EXAMPLE_PROMPT_PAIRS
        elif args.pairs == ["generic"]:
            pairs = IQA_PROMPT_PAIRS
        else:
            bad = [p for p in args.pairs if "|" not in p]
            if bad:
                p.error(
                    f"--pairs entries must be 'positive|negative' (or the "
                    f"single word 'generic'); got {bad}"
                )
            pairs = tuple(tuple(p.split("|", 1)) for p in args.pairs)
        tok, enc_img, enc_txt = _clip_encoders(args.tokenizer_dir, args.clip_model, device)
        iqa = ClipIQA(tok, enc_img, enc_txt, pairs)
        worst = find_bad_examples(
            _image_paths(args.root), iqa, lambda pth: _load01(pth, 224),
            worst_k=args.worst_k,
        )
        for pth, score in worst:
            print(f"{score:.4f}  {pth}")
    elif args.cmd == "similar":
        _, enc_img, _ = _clip_encoders(args.tokenizer_dir, args.clip_model, device)
        embs: Dict[str, np.ndarray] = {}
        for subject in sorted(os.listdir(args.root)):
            sdir = os.path.join(args.root, subject, "subject")
            if not os.path.isdir(sdir):
                continue
            paths = _image_paths(sdir)[: args.per_subject]
            if not paths:
                continue
            imgs = np.stack([_load01(pth, 224) for pth in paths])
            embs[subject] = enc_img(imgs).float().cpu().numpy().mean(axis=0)
        for a, b, sim in find_similar_subjects(embs, args.threshold):
            print(f"{sim:.4f}  {a}  {b}")
    elif args.cmd == "inspect":
        from edgestyle_tpu_torch.data.collate import CollateFn
        from edgestyle_tpu_torch.data.dataset import EdgeStyleLocalDataset
        from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids

        ds = EdgeStyleLocalDataset(args.root)
        rng = np.random.default_rng(args.seed)
        idx = rng.choice(len(ds), size=min(args.n, len(ds)), replace=False)
        collate = CollateFn(
            empty_prompt_ids()[0], proportion_patchworked_images=0.5,
            proportion_cutout_images=0.5, proportion_patchworks=0.5,
        )
        out = inspect_dataset_grid(
            [ds.example(int(i)) for i in idx], collate, rng, args.out
        )
        print(f"wrote {out}")


if __name__ == "__main__":
    main()

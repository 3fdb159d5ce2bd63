"""Local training dataset: per-subject artifact folders → training pairs.

A copy of edgestyle_tpu/data/dataset.py. Mirrors the reference's
dataset_local.py: each subject directory holds the
extraction artifacts (processed/, openpose/, subject/, agnostic/, head/,
clothes/); training examples are ordered pairs (target frame, clothes
donor frames) from permutations of frames of the same subject
(:249-254), remapped to the 10-image schema (:256-291). CLIP-similarity
pair filtering (keep 0.80–0.90 cosine, :40-41,298-318) is available via
`filter_pairs` when a similarity fn is supplied
(data/prompts.py::clip_similarity over the CLIP vision tower).

Directory layout per subject:
  <root>/<subject>/processed/<frame>.jpg     (original)
  <root>/<subject>/openpose/<frame>.jpg
  <root>/<subject>/subject/<frame>.jpg       (target: person on gray bg)
  <root>/<subject>/agnostic/<frame>.jpg
  <root>/<subject>/head/<frame>.jpg
  <root>/<subject>/clothes/<frame>.jpg
"""

from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from edgestyle_tpu_torch.data.collate import CollateFn, shard_for_accum

ARTIFACTS = ("processed", "openpose", "subject", "agnostic", "head", "clothes")


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class EdgeStyleLocalDataset:
    """Index of (subject, target_frame, donor1_frame, donor2_frame) triples."""

    def __init__(self, root: str, resolution: int = 512,
                 tokenize: Optional[Callable[[str], np.ndarray]] = None,
                 skip_marker: str = "_skip_"):
        self.root = root
        self.resolution = resolution
        self.tokenize = tokenize
        self.index: List[Tuple[str, str, str, str]] = []
        for subject in sorted(os.listdir(root)):
            sdir = os.path.join(root, subject)
            if not os.path.isdir(sdir) or skip_marker in subject:
                continue
            if os.path.exists(os.path.join(sdir, skip_marker)):
                continue
            pdir = os.path.join(sdir, "processed")
            if not os.path.isdir(pdir):
                continue
            frames = sorted(os.path.splitext(f)[0] for f in os.listdir(pdir))
            frames = [
                f for f in frames
                if all(
                    _exists_any(os.path.join(sdir, a), f) for a in ARTIFACTS
                )
            ]
            # permutations of 3 distinct frames (reference :249-254)
            for t, c1, c2 in itertools.permutations(frames, 3):
                self.index.append((subject, t, c1, c2))

    def __len__(self):
        return len(self.index)

    def _art(self, subject: str, artifact: str, frame: str) -> np.ndarray:
        return _load_image(_find(os.path.join(self.root, subject, artifact), frame))

    def example(self, i: int) -> Dict[str, np.ndarray]:
        subject, t, c1, c2 = self.index[i]
        a = lambda art, fr: self._art(subject, art, fr)
        ex = {
            "original": a("subject", t),
            "agnostic": a("agnostic", t),
            "head": a("head", t),
            "original_openpose": a("openpose", t),
            "target": a("subject", c1),
            "clothes": a("clothes", c1),
            "clothes_openpose": a("openpose", c1),
            "target2": a("subject", c2),
            "clothes2": a("clothes", c2),
            "clothes_openpose2": a("openpose", c2),
        }
        if self.tokenize:
            ex["input_ids"] = self.tokenize("edgestyle")
        else:
            ex["input_ids"] = np.zeros(77, np.int32)
        return ex


def _exists_any(dirpath: str, stem: str) -> bool:
    for ext in (".jpg", ".jpeg", ".png"):
        if os.path.exists(os.path.join(dirpath, stem + ext)):
            return True
    return False


def _find(dirpath: str, stem: str) -> str:
    for ext in (".jpg", ".jpeg", ".png"):
        p = os.path.join(dirpath, stem + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"{dirpath}/{stem}.*")


def filter_pairs(
    ds: EdgeStyleLocalDataset,
    similarity_fn: Callable[[np.ndarray, np.ndarray], float],
    min_score: float = 0.80,
    max_score: float = 0.90,
) -> None:
    """Drop pairs whose (target, donor) CLIP similarity is outside
    [min, max] (reference dataset_local.py:40-41,298-318). Mutates index."""
    kept = []
    for subject, t, c1, c2 in ds.index:
        s1 = similarity_fn(ds._art(subject, "subject", t), ds._art(subject, "subject", c1))
        s2 = similarity_fn(ds._art(subject, "subject", t), ds._art(subject, "subject", c2))
        if min_score <= s1 <= max_score and min_score <= s2 <= max_score:
            kept.append((subject, t, c1, c2))
    ds.index = kept


def data_loader(
    ds: EdgeStyleLocalDataset,
    batch_size: int,
    grad_accum: int,
    seed: int = 0,
    proportions: Optional[Dict[str, float]] = None,
    empty_prompt: Optional[np.ndarray] = None,
    num_workers: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled loader → batches shaped (grad_accum, mb, ...).

    ``num_workers`` fans the per-example image loads over a thread pool
    (order-preserving, so batches are byte-identical to the synchronous
    path — the reference's DataLoader ``--dataloader_num_workers`` analog,
    train...py:426,973); wrap the returned iterator in
    ``data.prefetch.prefetch`` to also overlap collate with device steps.
    """
    from edgestyle_tpu_torch.data.prefetch import parallel_map

    proportions = proportions or {}
    collate = CollateFn(
        empty_prompt=empty_prompt if empty_prompt is not None else np.zeros(77, np.int32),
        uses_vae=True,
        **proportions,
    )
    rng = np.random.default_rng(seed)
    order = np.arange(len(ds))
    while True:
        rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[start : start + batch_size]
            examples = parallel_map(ds.example, list(idx), workers=num_workers)
            batch = collate(examples, rng)
            yield shard_for_accum(batch, grad_accum)

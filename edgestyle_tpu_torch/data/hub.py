"""The EdgeStyle dataset in the HF ``datasets`` format (the reference's
dataset.py and push_dataset.py): the andrei-ace/EdgeStyle schema of ten
images and ``input_ids``, decoded from bytes to numpy HWC uint8, with the
fixed four-example test split.

Counterpart of edgestyle_tpu/data/hub.py. ``datasets`` is imported inside
the functions that need it: it is an optional package. A local
``save_to_disk`` directory loads offline; a hub id, and
:func:`push_dataset`, need the network.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List

import numpy as np

SCHEMA_FIELDS = (
    "original", "agnostic", "head", "original_openpose", "target", "clothes",
    "clothes_openpose", "target2", "clothes2", "clothes_openpose2",
)
TEST_SPLIT_SIZE = 4  # reference dataset.py:74


def _decode(value) -> np.ndarray:
    from PIL import Image

    if isinstance(value, dict) and "bytes" in value:
        value = value["bytes"]
    if isinstance(value, (bytes, bytearray)):
        with Image.open(io.BytesIO(value)) as im:
            return np.asarray(im.convert("RGB"))
    if hasattr(value, "convert"):  # PIL image
        return np.asarray(value.convert("RGB"))
    return np.asarray(value)


def example_from_row(row: Dict) -> Dict[str, np.ndarray]:
    ex = {f: _decode(row[f]) for f in SCHEMA_FIELDS if f in row}
    if "input_ids" in row:
        ex["input_ids"] = np.asarray(row["input_ids"], np.int32)
    else:
        ex["input_ids"] = np.zeros(77, np.int32)
    return ex


def load_hub_dataset(name_or_path: str, split: str = "train"):
    """Load through ``datasets``: a ``save_to_disk`` directory (or any
    local dataset directory), or a hub id where there is a network (the
    reference's dataset.py:69 loads andrei-ace/EdgeStyle). Returns
    (train_rows, test_rows) with the reference's fixed first-4 test split
    (dataset.py:74)."""
    import datasets

    if os.path.isdir(name_or_path) and (
        os.path.exists(os.path.join(name_or_path, "dataset_info.json"))
        or os.path.exists(os.path.join(name_or_path, split, "dataset_info.json"))
    ):
        ds = datasets.load_from_disk(name_or_path)
        if not isinstance(ds, datasets.Dataset):  # DatasetDict
            ds = ds[split]
    else:
        ds = datasets.load_dataset(name_or_path, split=split)
    n = len(ds)
    test = [example_from_row(ds[i]) for i in range(min(TEST_SPLIT_SIZE, n))]
    train_idx = list(range(min(TEST_SPLIT_SIZE, n), n))
    return _LazyRows(ds, train_idx), test


def dataset_from_examples(examples, cache_dir=None):
    """Examples (dicts in the 10-image + input_ids schema, e.g. from
    data/dataset.py::EdgeStyleLocalDataset.example) -> a ``datasets.Dataset``
    with Image features, the structure the reference builds in
    dataset_local.py:322-330 before pushing (push_dataset.py:7). The rows
    are written to ``cache_dir`` (``datasets``' own cache when None)."""
    import datasets
    from PIL import Image

    feats = datasets.Features({
        **{f: datasets.Image() for f in SCHEMA_FIELDS},
        "input_ids": datasets.Sequence(datasets.Value("int32")),
    })

    def gen():
        for ex in examples:
            row = {
                f: Image.fromarray(np.asarray(ex[f], np.uint8))
                for f in SCHEMA_FIELDS
            }
            row["input_ids"] = np.asarray(ex["input_ids"], np.int32).tolist()
            yield row

    return datasets.Dataset.from_generator(gen, features=feats, cache_dir=cache_dir)


def save_dataset(ds, path: str) -> None:
    """Arrow save: the directory :func:`load_hub_dataset` reads back offline."""
    ds.save_to_disk(path)


def push_dataset(ds, repo_id: str):
    """The reference's push_dataset.py:7 (``push_to_hub``). It needs the
    network: a failure raises with the offline route named."""
    try:
        return ds.push_to_hub(repo_id)
    except Exception as e:
        raise RuntimeError(
            f"push_to_hub({repo_id!r}) failed: without network access, "
            f"save_dataset() and push from a connected host: {e}"
        ) from e


class _LazyRows:
    def __init__(self, ds, indices: List[int]):
        self.ds = ds
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def example(self, i: int) -> Dict[str, np.ndarray]:
        return example_from_row(self.ds[self.indices[i]])

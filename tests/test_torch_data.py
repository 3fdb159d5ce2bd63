"""The port's dataset, loader, augmentations and prefetch, and the trainer
on a dataset, against the JAX package on the CPU.

The loader is host numpy in both packages, copied: the same tree and seed
must give bit-equal batches.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

from edgestyle_tpu.data import dataset as jdataset
from edgestyle_tpu_torch.apps import train as train_app
from edgestyle_tpu_torch.data import dataset, prefetch
from edgestyle_tpu_torch.training.train_step import BATCH_KEYS
from edgestyle_tpu_torch.models.vae import VAEConfig
from tests.test_torch_training import TRAIN_CFG
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

# The collate's images are 512 px whatever --resolution says: a VAE and a
# cond embedding of five levels keep the TINY models' latents at 32 x 32 (the
# two-level TINY VAE would attend over 256 x 256 tokens in its mid block)
DATA_CFG = dataclasses.replace(
    TRAIN_CFG, vae=VAEConfig(block_out_channels=(32,) * 5, layers_per_block=1),
    unet=dataclasses.replace(TRAIN_CFG.unet, cond_embedding_channels=(8, 8, 8, 8, 16)))


ARTS = ("processed", "openpose", "subject", "agnostic", "head", "clothes")
ALL_HALF = dict(proportion_empty_prompts=0.5, proportion_empty_images=0.5,
                proportion_patchworked_images=0.5, proportion_cutout_images=0.5,
                proportion_patchworks=0.5)
# the proportions are cumulative thresholds on fresh draws, so at 0.5 each
# the patchwork and cutout branches are never reached; at 0.15 each all are
SPREAD = dict(proportion_empty_prompts=0.15, proportion_empty_images=0.15,
              proportion_patchworked_images=0.15, proportion_cutout_images=0.15,
              proportion_patchworks=0.5)


def make_tree(root, subjects=("s1", "s2"), frames=("f0", "f1", "f2"), size=64):
    """tests/test_apps.py::_make_tree's layout: 64 px seeded JPEGs."""
    g = np.random.default_rng(0)
    for s in subjects:
        for a in ARTS:
            d = os.path.join(root, s, a)
            os.makedirs(d, exist_ok=True)
            for f in frames:
                img = g.integers(0, 255, (size, size, 3), dtype=np.uint8)
                Image.fromarray(img).save(os.path.join(d, f + ".jpg"))
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("ds"))


def assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert a[k].dtype == v.dtype and np.array_equal(a[k], v), k


@pytest.mark.parametrize("props", [ALL_HALF, SPREAD], ids=["all_half", "spread"])
def test_data_loader_matches_jax(tree, props):
    """Seed 3, batch 4 in 2 accumulation slices, 3 batches: every key bit-equal."""
    ds, jds = dataset.EdgeStyleLocalDataset(tree), jdataset.EdgeStyleLocalDataset(tree)
    assert ds.index == jds.index and len(ds) == 12
    ours = dataset.data_loader(ds, 4, 2, seed=3, proportions=props)
    ref = jdataset.data_loader(jds, 4, 2, seed=3, proportions=props)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a["original"].shape == (2, 2, 512, 512, 3)
        assert_batches_equal(a, b)


def test_workers_and_prefetch_match_the_synchronous_loader(tree):
    """2 workers behind a depth-2 prefetch give the synchronous batches."""
    ds = dataset.EdgeStyleLocalDataset(tree)
    sync = dataset.data_loader(ds, 4, 1, seed=5, proportions=SPREAD)
    with prefetch.prefetch(dataset.data_loader(ds, 4, 1, seed=5, proportions=SPREAD,
                                               num_workers=2), depth=2) as fast:
        for _ in range(3):
            assert_batches_equal(next(fast), next(sync))


def test_prefetch_keeps_order_and_ends():
    assert list(prefetch.PrefetchIterator(iter(range(50)), depth=2)) == list(range(50))
    assert prefetch.prefetch(iter([1]), depth=0).__class__ is not prefetch.PrefetchIterator
    with pytest.raises(ValueError):
        prefetch.PrefetchIterator(iter([]), depth=0)


def test_prefetch_raises_the_producers_error_after_its_items():
    def source():
        yield from range(3)
        raise KeyError("bad example")

    it = prefetch.PrefetchIterator(source())
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="bad example"):
        next(it)


def test_prefetch_close_stops_an_infinite_source():
    """close() mid-stream stops the producer thread (idempotent) and ends
    the stream; a consumer blocked on an empty queue in another thread
    returns within a timeout."""
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = prefetch.PrefetchIterator(endless(), depth=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)

    def slow():
        time.sleep(30)
        yield 0

    blocked = prefetch.PrefetchIterator(slow(), depth=1)
    got = []
    consumer = threading.Thread(target=lambda: got.append(list(blocked)), daemon=True)
    consumer.start()
    time.sleep(0.2)
    blocked._stop.set()
    consumer.join(timeout=5.0)
    assert not consumer.is_alive() and got == [[]]


def test_filter_pairs_matches_jax(tree):
    """A stub similarity from the images: the same triples kept, in order;
    all kept at 0.85, none at 0.5."""
    def sim(a, b):  # the frames' mean levels differ by up to ~1.6
        return 0.85 + (float(a.mean()) - float(b.mean())) / 20.0

    ds, jds = dataset.EdgeStyleLocalDataset(tree), jdataset.EdgeStyleLocalDataset(tree)
    dataset.filter_pairs(ds, sim)
    jdataset.filter_pairs(jds, sim)
    assert ds.index == jds.index and 0 < len(ds) < 12
    for score, kept in ((0.85, 12), (0.5, 0)):
        ds = dataset.EdgeStyleLocalDataset(tree)
        dataset.filter_pairs(ds, lambda a, b: score)
        assert len(ds) == kept


def test_dataset_example_ids_are_zeros_without_a_tokenizer(tree):
    """The JAX trainer builds its dataset without ``tokenize``, so every
    example's input_ids are zeros(77), as are the collate's empty prompt's;
    the port does the same."""
    ex = dataset.EdgeStyleLocalDataset(tree).example(0)
    jex = jdataset.EdgeStyleLocalDataset(tree).example(0)
    assert ex.keys() == jex.keys()
    for k, v in jex.items():
        assert np.array_equal(ex[k], v), k
    assert ex["input_ids"].shape == (77,) and not ex["input_ids"].any()


def jax_train_steps(args, n_index):
    """edgestyle_tpu/apps/train.py's loop length, written out."""
    if args.dataset_dir:
        n = min(n_index, args.max_train_samples) if args.max_train_samples else n_index
        spe = max(n // (args.train_batch_size * args.gradient_accumulation_steps), 1)
    else:
        spe = 1000
    return args.max_train_steps or args.num_train_epochs * spe


@pytest.mark.parametrize("flags", [
    [], ["--num_train_epochs", "3"], ["--max_train_steps", "7"],
    ["--dataset_dir", "D", "--num_train_epochs", "2"],
    ["--dataset_dir", "D", "--train_batch_size", "1", "--max_train_samples", "5"],
    ["--dataset_dir", "D", "--gradient_accumulation_steps", "32"],
    ["--dataset_dir", "D", "--max_train_steps", "2"],
])
def test_train_steps_match_the_jax_formula(tree, flags):
    args = train_app.parse_args([f if f != "D" else tree for f in flags] + ["--random_init"])
    assert train_app.train_steps(args) == jax_train_steps(args, 12)


def test_the_five_proportion_flags_reach_the_collate(tree, monkeypatch):
    """The trainer's dataset loader: the CollateFn gets the five flags' values,
    and its batches are the JAX loader's with those proportions, in NCHW,
    the step's keys only, int64 ids."""
    flags = {"proportion_empty_prompts": 0.1, "proportion_empty_images": 0.2,
             "proportion_patchworked_images": 0.15, "proportion_cutout_images": 0.25,
             "proportion_patchworks": 0.3}
    argv = ["--random_init", "--dataset_dir", tree, "--seed", "4", "--train_batch_size", "2",
            "--gradient_accumulation_steps", "2", "--max_train_samples", "10"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    seen = []
    real = dataset.CollateFn
    monkeypatch.setattr(dataset, "CollateFn", lambda **kw: seen.append(kw) or real(**kw))
    ours = train_app.dataset_loader(train_app.parse_args(argv))
    jds = jdataset.EdgeStyleLocalDataset(tree)
    jds.index = jds.index[:10]
    ref = jdataset.data_loader(jds, 4, 2, seed=4, proportions=flags)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert set(a) == set(BATCH_KEYS)
        for k in BATCH_KEYS:
            want = b[k].astype(np.int64) if k == "input_ids" else b[k].transpose(0, 1, 4, 2, 3)
            assert a[k].dtype == want.dtype and np.array_equal(a[k], want), k
    assert len(seen) == 1 and {k: seen[0][k] for k in flags} == flags


def test_the_ported_flags_pass_on_one_card(tree):
    train_app.check_supported(train_app.parse_args(
        ["--random_init", "--dataset_dir", tree, "--validation_steps", "2",
         "--dataloader_num_workers", "2", "--max_train_samples", "4"]))


class _Writer:
    """tensorboardX's SummaryWriter surface that the trainer calls."""

    def __init__(self):
        self.scalars, self.images, self.closed = [], [], False

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def add_image(self, tag, img, step, dataformats):
        self.images.append((tag, img.shape, step, dataformats))

    def close(self):
        self.closed = True


def test_train_main_on_a_dataset_with_prefetch_and_validation(tree, tmp_path, monkeypatch):
    """apps/train.py on the dataset at TINY width, 512 px (the collate's
    size), 2 workers and prefetch, validation every 2 steps through a stub
    writer: 2 steps logged with finite losses and a monotone d, one grid of
    the first micro-batch (capped at --num_validation_images) logged at step
    2, the writer closed."""
    writer = _Writer()
    monkeypatch.setattr(train_app, "summary_writer", lambda args: writer)
    argv = ["--random_init", "--dataset_dir", tree, "--resolution", "512",
            "--train_batch_size", "1", "--gradient_accumulation_steps", "1",
            "--max_train_steps", "2", "--logging_steps", "1", "--controllora_linear_rank", "4",
            "--mixed_precision", "no", "--dataloader_num_workers", "2", "--validation_steps", "2",
            "--num_validation_images", "1", "--output_dir", str(tmp_path)]
    for k in SPREAD:
        argv += [f"--{k}", "0.2"]
    out = train_app.main(argv, device="cpu", base_cfg=DATA_CFG)
    assert [r["step"] for r in out["log"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in out["log"])
    assert out["log"][1]["d"] >= out["log"][0]["d"]
    assert writer.images == [("validation", (4 * 512, 512, 3), 2, "HWC")]
    assert ("train_loss", 2) in writer.scalars and writer.closed

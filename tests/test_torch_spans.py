"""The port's profiler spans (core/spans.py): free outside a profiler, the
named ranges of a TINY try-on request and train step under one, and the
same results with the profiler on and off. Torch and the port only."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from edgestyle_tpu_torch.core import spans
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.training.checkpoint import states_equal
from edgestyle_tpu_torch.training.train_step import make_train_step, sample_draws
from tests.torch_multicard_workers import TINY_PIPE, train_setup
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

NAMES = [v for k, v in vars(spans).items() if k.isupper() and isinstance(v, str)]


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _recorded(prof):
    """The spans of a CPU trace: name -> [(start, end, thread)]. Each is an
    operator range, not a user annotation, so a trace with the device has
    no device copy of it."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("edgestyle/"):
            assert not e.is_user_annotation(), e.name()
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns(), e.start_thread_id()))
    return out


def test_span_off_makes_no_torch_call(monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"a range {name!r} opened outside a profiler")

    monkeypatch.setattr(spans, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert len(NAMES) == 12 and all(n.startswith("edgestyle/") for n in NAMES)
    with CountOps() as mode:
        for name in NAMES:
            with spans.span(name):
                pass
    assert mode.n == 0
    assert spans.span(spans.GEN) is spans.span(spans.UNET)  # one shared no-op
    with CountOps() as mode:
        torch.ones(2) + 1
    assert mode.n > 0  # the mode counts what does dispatch


@pytest.fixture(scope="module")
def generated():
    """A 2-step TINY request, profiler off, then on."""
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    params = pipe.init_params(make_generator(0, "cpu"))
    g = torch.Generator().manual_seed(1)
    s = TINY_PIPE.vae.sample_size
    ids, neg = (torch.randint(1, 99, (1, 7), generator=g) for _ in range(2))
    imgs = [torch.rand((1, 3, s, s), generator=g) for _ in range(6)]
    lat = torch.randn((1, 4, s // 2, s // 2), generator=g)

    def run():
        return pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=2)

    off = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    return off, on, _recorded(prof)


def test_generation_spans(generated):
    rec = generated[2]
    assert {k: len(v) for k, v in rec.items()} == {
        spans.GEN: 1, spans.CLIP: 1, spans.VAE_ENCODE: 1, spans.VAE_DECODE: 1,
        spans.MCN: 2, spans.MCN_FUSION: 2, spans.UNET: 2}
    (g0, g1, tid), = rec[spans.GEN]
    for name, inst in rec.items():
        assert all(g0 <= s <= e <= g1 and t == tid for s, e, t in inst), name
    fused = [(s, e) for s, e, _ in rec[spans.MCN_FUSION]]
    assert all(any(a <= s <= e <= b for a, b, _ in rec[spans.MCN]) for s, e in fused)


def test_generation_same_with_profiler(generated):
    off, on, _ = generated
    assert torch.equal(off, on)


@pytest.fixture(scope="module")
def trained():
    """One TINY step at grad_accum 2 (the trainer's build), profiler off,
    then on."""
    from edgestyle_tpu_torch.apps import train as train_app

    pipe, frozen, tcfg, state, host = train_setup(7)
    assert tcfg.grad_accum == 2
    draws = sample_draws(pipe, tcfg, host, make_generator(11, "cpu"))
    batch, draws = train_app.rank_batch(None, host, draws)
    step = make_train_step(pipe, tcfg)
    off, m_off = step(state, frozen, batch, draws)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on, m_on = step(state, frozen, batch, draws)
    return (off, m_off), (on, m_on), _recorded(prof)


def test_train_step_spans(trained):
    count = Counter({k: len(v) for k, v in trained[2].items()})
    assert count[spans.TRAIN_STEP] == 1 and count[spans.TRAIN_OPTIMIZER] == 1
    for name in (spans.TRAIN_ACCUMULATE, spans.TRAIN_BACKWARD, spans.TRAIN_MERGE_LORA,
                 spans.CLIP, spans.MCN, spans.UNET):
        assert count[name] == 2, name
    assert count[spans.VAE_ENCODE] == 4  # the target and the three VAE conds a micro-batch
    (s0, s1, _), = trained[2][spans.TRAIN_STEP]
    assert all(s0 <= s <= e <= s1 for inst in trained[2].values() for s, e, _ in inst)


def test_train_step_same_with_profiler(trained):
    (off, m_off), (on, m_on), _ = trained
    assert states_equal(off, on)
    assert torch.equal(m_off["loss"], m_on["loss"]) and torch.equal(m_off["d"], m_on["d"])

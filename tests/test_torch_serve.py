"""The port's server (apps/serve.py) on the CPU: real HTTP round trips against
the stdlib server with stub systems, the batcher's coalescing, grouping and
failure rules, ``encode_prompts`` against the JAX package's, the Gradio
callbacks' wiring, ``TryOnSystem.generate_batch`` and ``generate`` against
the JAX package's (both pipelines stubbed), and generate_batch's rows
against one request at a time through ``generate`` at the MID
configuration.
"""

import base64
import dataclasses
import io
import json
import logging
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from edgestyle_tpu.apps import serve as jserve
from edgestyle_tpu.data.tokenizer import CLIPTokenizer as JCLIPTokenizer
from edgestyle_tpu_torch.apps import serve, tryon
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.data.tokenizer import CLIPTokenizer, make_byte_tokenizer
from edgestyle_tpu_torch.models.vae import VAEConfig
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from tests import test_torch_pretrained as pretrained
from tests.test_torch_pipeline import TINY_PIPE
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

COND_KEYS = ("agnostic", "subject_pose", "clothes1", "clothes1_pose", "clothes2",
             "clothes2_pose")
JOIN_S = 30  # every join and wait in this file is bounded


class StubSystem:
    """The single-request path: the subject photo, dimmed."""

    def __call__(self, s, c1, c2, ids, neg, steps, guidance, seed):
        return np.clip(s * 0.5 + 0.25, 0, 1)


class StubBatchSystem:
    """The batched path: each output row holds its request's guidance / 10,
    so routing is visible; every call is recorded."""

    def __init__(self, batch_prepare_fails=False):
        self.calls = []
        self.prepared = []
        self.batch_prepare_fails = batch_prepare_fails
        self.lock = threading.Lock()

    def prepare_cond(self, s, c1, c2):
        with self.lock:
            self.prepared.append(float(s.flat[0]))
        return {k: s for k in COND_KEYS}

    def prepare_cond_batch(self, ss, c1s, c2s):
        if self.batch_prepare_fails:
            raise RuntimeError("pose net out of memory")
        return [{k: s for k in COND_KEYS} for s in ss]

    def generate_batch(self, conds, ids, neg, steps, guidance, seeds):
        with self.lock:
            self.calls.append({"B": len(conds), "steps": steps, "guidance": list(guidance),
                               "seeds": list(seeds), "ids": ids.shape})
        return np.stack([np.full((512, 512, 3), g / 10.0, np.float32) for g in guidance])


def _start(args, system):
    srv = serve.build_server(args, system, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture()
def server():
    srv, url = _start(serve.parse_args(["--port", "0", "--random_init"]), StubSystem())
    yield url
    srv.shutdown()
    srv.server_close()


def _b64_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, payload: bytes):
    req = urllib.request.Request(url + "/tryon", data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=JOIN_S) as r:
        return r.headers["Content-Type"], r.read()


def _payload(img, **kw):
    return json.dumps({"subject": _b64_png(img), "clothes1": _b64_png(img),
                       "clothes2": _b64_png(img), **kw}).encode()


def test_healthz_and_404s(server):
    with urllib.request.urlopen(server + "/healthz", timeout=JOIN_S) as r:
        assert json.loads(r.read()) == {"ok": True}
    for req in (urllib.request.Request(server + "/nope"),
                urllib.request.Request(server + "/nope", data=b"{}", method="POST")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=JOIN_S)
        assert e.value.code == 404


def test_tryon_roundtrip_and_bad_payloads(server):
    """A PNG of the system's image; a malformed body, a missing image and a
    per-request prompt without a tokenizer each get a 400 with the error,
    and the server goes on serving."""
    img = np.random.default_rng(0).integers(0, 255, (512, 512, 3), dtype=np.uint8)
    ctype, body = _post(server, _payload(img, steps=2))
    out = np.asarray(Image.open(io.BytesIO(body)))
    assert ctype == "image/png" and out.shape == (512, 512, 3)
    want = (np.clip(img / 255.0 * 0.5 + 0.25, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(out, want)
    missing = json.dumps({"subject": _b64_png(img)}).encode()
    for bad, match in ((b"{not json", "Expecting"), (missing, "clothes1"),
                       (_payload(img, prompt="a red shirt"), "tokenizer_dir")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, bad)
        assert e.value.code == 400
        assert match in json.loads(e.value.read())["error"]
    assert _post(server, _payload(img))[0] == "image/png"


def _submit_all(batcher, reqs):
    """Submit each (key, steps, guidance) from its own thread; {key: result
    or exception}."""
    out = {}
    img = np.zeros((512, 512, 3), np.float32)

    def call(key, steps, guidance):
        try:
            out[key] = batcher.submit(img + key, img, img, None, "", steps, guidance,
                                      seed=key)
        except Exception as e:  # noqa: BLE001 -- the test reads it
            out[key] = e

    threads = [threading.Thread(target=call, args=r) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    return out


def test_batching_coalesces_and_routes():
    """Three concurrent requests within the window become fewer generations
    than requests, each caller gets its own row (by its guidance), and the
    seeds and per-request guidance reach generate_batch."""
    sys_ = StubBatchSystem()
    out = _submit_all(serve.BatchingTryOn(sys_, max_batch=4, window_s=0.25),
                      [(1, 5, 1.0), (2, 5, 2.0), (3, 5, 3.0)])
    for k in (1, 2, 3):
        np.testing.assert_allclose(out[k][0, 0, 0], k / 10.0)
    assert 1 <= len(sys_.calls) <= 2 and sum(c["B"] for c in sys_.calls) == 3
    assert sorted(s for c in sys_.calls for s in c["seeds"]) == [1, 2, 3]
    assert all(c["ids"] == (c["B"], 77) for c in sys_.calls)


def test_batching_groups_by_steps():
    """Step counts split a window into generations: two requests at 4 steps
    run together, the one at 9 alone."""
    sys_ = StubBatchSystem()
    _submit_all(serve.BatchingTryOn(sys_, max_batch=4, window_s=0.5),
                [(1, 4, 3.5), (2, 4, 3.5), (3, 9, 3.5)])
    by_steps = sorted((c["steps"], c["B"]) for c in sys_.calls)
    assert sum(b for _, b in by_steps) == 3 and (9, 1) in by_steps
    assert all(b == 2 for s, b in by_steps if s == 4) or len(sys_.calls) == 3


def test_batching_a_failing_request_does_not_fail_its_group():
    """A request whose own preparation raises (here: a prompt without a
    tokenizer) gets its error; the other requests of its window are
    generated."""
    sys_ = StubBatchSystem()
    b = serve.BatchingTryOn(sys_, max_batch=3, window_s=0.25)
    img = np.zeros((512, 512, 3), np.float32)
    out = {}

    def call(key, prompt):
        try:
            out[key] = b.submit(img, img, img, prompt, "", 4, float(key), seed=key)
        except Exception as e:  # noqa: BLE001
            out[key] = e

    threads = [threading.Thread(target=call, args=(k, p))
               for k, p in ((1, None), (2, "a red shirt"), (3, None))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert isinstance(out[2], RuntimeError) and "tokenizer_dir" in str(out[2])
    for k in (1, 3):
        np.testing.assert_allclose(out[k][0, 0, 0], k / 10.0)
    assert sum(c["B"] for c in sys_.calls) == 2


def test_batching_falls_back_to_per_request_preparation_once(caplog):
    """When the batched preprocessing raises, a one-line warning is logged
    and each request is prepared alone, exactly once."""
    sys_ = StubBatchSystem(batch_prepare_fails=True)
    with caplog.at_level(logging.WARNING, logger=serve.__name__):
        out = _submit_all(serve.BatchingTryOn(sys_, max_batch=3, window_s=0.25),
                          [(1, 4, 1.0), (2, 4, 2.0), (3, 4, 3.0)])
    assert all(isinstance(v, np.ndarray) for v in out.values())
    assert sorted(sys_.prepared) == [1.0, 2.0, 3.0]
    warnings = [r for r in caplog.records if "batched preprocessing" in r.getMessage()]
    assert warnings and all("pose net out of memory" in r.getMessage() for r in warnings)


def test_batching_generation_error_reaches_every_caller():
    class Boom(StubBatchSystem):
        def generate_batch(self, *a, **k):
            raise RuntimeError("card on fire")

    out = _submit_all(serve.BatchingTryOn(Boom(), max_batch=2, window_s=0.05),
                      [(1, 2, 3.5), (2, 2, 3.5)])
    assert all(isinstance(v, RuntimeError) and "card on fire" in str(v) for v in out.values())
    assert out[1] is not out[2]


def test_server_with_batching_roundtrip():
    """HTTP through the batcher (--max_batch 3): the request's guidance row."""
    args = serve.parse_args(["--port", "0", "--random_init", "--max_batch", "3",
                             "--batch_window_ms", "20"])
    srv, url = _start(args, StubBatchSystem())
    try:
        img = np.random.default_rng(1).integers(0, 255, (512, 512, 3), dtype=np.uint8)
        _, body = _post(url, _payload(img, steps=2, guidance=5.0))
        out = np.asarray(Image.open(io.BytesIO(body)))
        assert out.shape == (512, 512, 3)
        np.testing.assert_allclose(out[0, 0, 0] / 255.0, 0.5, atol=0.01)
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("prompt,mined", [(None, None), ("a red shirt", None),
                                          (None, "edgestyle, blue, jacket")])
def test_encode_prompts_matches_jax(tmp_path, prompt, mined):
    """ids equal the JAX package's for the same tokenizer files: no
    tokenizer (the BOS/EOS empty prompt), an explicit prompt, and a prompt
    mined from the clothes photo."""
    tok_dir = str(tmp_path / "tok")
    make_byte_tokenizer().save_pretrained(tok_dir)
    clothes = np.zeros((8, 8, 3), np.float32)
    miner = (lambda imgs: [mined] * len(imgs)) if mined else None
    if prompt is None and mined is None:
        ours = serve.encode_prompts(None, None, None, "x", clothes)
        ref = jserve.encode_prompts(None, None, None, "x", jnp.asarray(clothes))
    else:
        ours = serve.encode_prompts(CLIPTokenizer.from_pretrained_dir(tok_dir), miner, prompt,
                                    "lowres", clothes)
        ref = jserve.encode_prompts(JCLIPTokenizer.from_pretrained_dir(tok_dir), miner, prompt,
                                    "lowres", jnp.asarray(clothes))
    for a, b in zip(ours, ref):
        assert a.shape == (1, 77)
        np.testing.assert_array_equal(a, np.asarray(b))


def test_gradio_callbacks_wire_the_two_steps():
    """preprocess: the head crop (or the agnostic one) and the skeleton of
    each photo, as uint8; try_on: the six images in [0, 1] with the ids,
    steps, guidance and seed handed to ``generate``."""

    class Sys:
        use_agnostic = False

        def __init__(self):
            self.generated = None

        def detect_pose(self, img01):
            return None, np.full((512, 512, 3), 0.5, np.float32)

        def extract(self, img01, kp):
            return {"head": img01 * 0.5, "agnostic": img01 * 0.25, "clothes": img01}

        def generate(self, cond, ids, neg, steps, guidance, seed):
            self.generated = (cond, ids, neg, steps, guidance, seed)
            return np.full((512, 512, 3), 0.2, np.float32)

    sys_ = Sys()
    cb = serve.GradioCallbacks(sys_, negative_prompt="lowres")
    img = np.full((512, 512, 3), 200, np.uint8)
    six = cb.preprocess(img, img, img)
    assert len(six) == 6 and all(a.dtype == np.uint8 for a in six)
    assert six[0][0, 0, 0] == int(200 / 255 * 0.5 * 255) and six[2][0, 0, 0] == 200
    out = cb.try_on(*six, 4.5, 7, seed=3)
    cond, ids, neg, steps, guidance, seed = sys_.generated
    assert (steps, guidance, seed) == (7, 4.5, 3) and set(cond) == set(COND_KEYS)
    assert ids.shape == (1, 77) and out.dtype == np.uint8 and out[0, 0, 0] == 51


GEN_ARGV = ["--subject", "s", "--clothes1", "a", "--clothes2", "b", "--random_init",
            "--controlnet_cache_interval", "2", "--cfg_interval", "0", "0.5"]
# (the call, its conds' count, guidance, seeds)
GEN_CASES = {"batch of two, per-request guidance": ("generate_batch", 2, [3.5, 6.0], [5, 9]),
             "batch of one, scalar guidance": ("generate_batch", 1, 4.5, [7]),
             "single request": ("generate", 1, 4.5, [7])}


@pytest.fixture
def stub_generation(monkeypatch):
    """Both packages' EdgeStylePipeline.__call__ stubbed (no model runs) to
    record what the try-on system hands it: the six cond images (the
    port's NCHW moved to NHWC), the ids, the latents (NHWC), the seed of the
    generator or key and every other argument. Returns {"jax": [...],
    "port": [...]}, one record per call."""
    import jax

    from edgestyle_tpu.pipelines import tryon as jtryon

    calls = {"jax": [], "port": []}

    def jax_call(self, params, ids, neg, imgs, rng=None, latents=None, **kw):
        calls["jax"].append({
            "cond": [np.asarray(i) for i in imgs], "ids": np.asarray(ids),
            "neg": np.asarray(neg), "latents": None if latents is None else np.asarray(latents),
            "seed": None if rng is None else int(jax.random.key_data(rng)[-1]), **kw})
        b, h, w, _ = imgs[0].shape
        return jnp.zeros((b, h, w, 3))

    def port_call(self, params, ids, neg, cond, generator=None, latents=None, **kw):
        calls["port"].append({
            "cond": [c.numpy().transpose(0, 2, 3, 1) for c in cond], "ids": np.asarray(ids),
            "neg": np.asarray(neg),
            "latents": None if latents is None else latents.numpy().transpose(0, 2, 3, 1),
            "seed": None if generator is None else generator.initial_seed(), **kw})
        b, _, h, w = cond[0].shape
        return torch.zeros((b, 3, h, w))

    monkeypatch.setattr(jtryon.EdgeStylePipeline, "__call__", jax_call)
    monkeypatch.setattr(EdgeStylePipeline, "__call__", port_call)
    return calls


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generation_calls_match_jax(stub_generation, case):
    """JAX's TryOnSystem and the port's on the same conds, ids, seeds and
    guidance (per request or scalar), both pipelines stubbed: the same six
    cond images (agnostic and clothes to [-1, 1], poses in [0, 1]) stacked
    in the same order, the same ids, steps, guidance and knobs, and latents
    of the same geometry (taken from the cond images, over the VAE's
    downscale). The port draws each row from its own seed's generator
    (``randn((1, 4, h, w))``) and hands a single request's generator on;
    JAX's single request hands its key on and leaves the draw to the
    pipeline."""
    from edgestyle_tpu.apps import tryon as japp
    from edgestyle_tpu.pipelines.tryon import EdgeStylePipeline as JPipeline
    from tests.test_pipeline import TINY_PIPE as J_TINY_PIPE

    method, b, guidance, seeds = GEN_CASES[case]
    rng = np.random.default_rng(4)
    conds = [{k: rng.random((32, 32, 3)).astype(np.float32) for k in COND_KEYS}
             for _ in range(b)]
    ids = rng.integers(1, 99, (b, 7))
    neg = rng.integers(1, 99, (b, 7))
    jsys = japp.TryOnSystem.__new__(japp.TryOnSystem)
    jsys.jax, jsys.jnp = __import__("jax"), jnp
    jsys._set_serving_knobs(japp.parse_args(GEN_ARGV))
    jsys.pipe = jsys._live_pipe = JPipeline(J_TINY_PIPE, attn_impl="xla")
    jsys.gen_params = {}
    system = tryon.TryOnSystem(args=tryon.parse_args(GEN_ARGV), device="cpu",
                               pipe=EdgeStylePipeline(TINY_PIPE, device="cpu"), gen_params={})
    if method == "generate":
        args = (conds[0], ids, neg, 6, guidance, seeds[0])
    else:
        args = (conds, ids, neg, 6, guidance, seeds)
    outs = {"jax": getattr(jsys, method)(*args), "port": getattr(system, method)(*args)}
    assert outs["port"].shape == outs["jax"].shape == ((32, 32, 3) if method == "generate"
                                                       else (b, 32, 32, 3))
    (j,), (p,) = stub_generation["jax"], stub_generation["port"]
    assert len(j["cond"]) == len(p["cond"]) == 6
    for a, c in zip(j["cond"], p["cond"]):
        np.testing.assert_array_equal(c, a)
    assert p["cond"][0].min() < 0 and p["cond"][1].min() >= 0
    for k in ("ids", "neg"):
        np.testing.assert_array_equal(p[k], j[k])
    np.testing.assert_array_equal(np.asarray(p.pop("guidance_scale")),
                                  np.asarray(j.pop("guidance_scale")))
    rest = ("cond", "ids", "neg", "latents", "seed")
    assert {k: v for k, v in p.items() if k not in rest} == {
        k: v for k, v in j.items() if k not in rest}
    assert p["num_inference_steps"] == 6 and p["controlnet_cache_interval"] == 2
    want = (b, 32 // system.pipe.vae_downscale, 32 // system.pipe.vae_downscale, 4)
    assert p["latents"].shape == want
    if j["latents"] is not None:
        assert j["latents"].shape == want and j["seed"] is None
    else:
        assert j["seed"] == seeds[0]
    for row, seed in zip(p["latents"], seeds):
        draw = torch.randn((1, 4, want[1], want[2]), generator=make_generator(seed, "cpu"))
        np.testing.assert_array_equal(row, draw.numpy()[0].transpose(1, 2, 0))
    assert p["seed"] == (seeds[0] if b == 1 else None)


MID_PIPE = dataclasses.replace(
    pretrained.MID_PIPE, vae=VAEConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                                       sample_size=64))


def test_generate_batch_rows_match_generate():
    """TryOnSystem.generate_batch on two requests (their own seeds and
    guidance) against ``generate`` one request at a time, at the MID
    configuration (4 UNet blocks 64-256 wide, the six-branch pattern, a
    4-block VAE downscaling by 8 as SD's) in fp32 on the CPU: each row
    within 1e-5 (the batch's sums may run in another order); mismatched
    seeds raise."""
    pipe = EdgeStylePipeline(MID_PIPE, device="cpu")
    params = pipe.init_params(make_generator(0, "cpu"))
    system = tryon.TryOnSystem(args=tryon.parse_args(
        ["--subject", "s", "--clothes1", "a", "--clothes2", "b", "--random_init"]),
        device="cpu", pipe=pipe, gen_params=params)
    rng = np.random.default_rng(3)
    px = MID_PIPE.vae.sample_size
    conds = [{k: rng.random((px, px, 3)).astype(np.float32) for k in COND_KEYS}
             for _ in range(2)]
    n = MID_PIPE.clip.max_positions
    ids = rng.integers(1, 99, (2, n))
    neg = rng.integers(1, 99, (2, n))
    out = system.generate_batch(conds, ids, neg, steps=3, guidance=[3.5, 6.0], seeds=[5, 9])
    assert out.shape == (2, px, px, 3)
    for j, (g, seed) in enumerate(((3.5, 5), (6.0, 9))):
        one = system.generate(conds[j], ids[j:j + 1], neg[j:j + 1], steps=3, guidance=g,
                              seed=seed)
        np.testing.assert_allclose(out[j], one, atol=1e-5)
    with pytest.raises(ValueError, match="one seed per request"):
        system.generate_batch(conds, ids, neg, seeds=[1])
    assert not torch.equal(torch.from_numpy(out[0]), torch.from_numpy(out[1]))


def test_int8_scales_flag_loads_the_table_into_the_pipeline(tmp_path, monkeypatch):
    """``--int8_scales`` (the server's and the try-on's flag) loads the table
    into the live pipeline, whose mode comes from EDGESTYLE_QUANT; a file
    that is not a table is refused at start-up."""
    table = {"unet/down_blocks_0/resnets_0/conv1/kernel": 0.02, "static/mid_block/x/kernel": 1.5}
    path = tmp_path / "scales.json"
    path.write_text(json.dumps(table))
    monkeypatch.setenv("EDGESTYLE_QUANT", "int8-static")
    pipe = EdgeStylePipeline(TINY_PIPE, device="cpu")
    args = serve.parse_args(["--random_init", "--int8_scales", str(path)])
    tryon.TryOnSystem(args=args, device="cpu", pipe=pipe, gen_params={})
    assert pipe.quant == "int8-static" and pipe._int8_scales == table
    path.write_text(json.dumps({"k": "x"}))
    with pytest.raises(ValueError, match="not an int8 scale table"):
        tryon.TryOnSystem(args=serve.parse_args(["--random_init", "--int8_scales", str(path)]),
                          device="cpu", pipe=pipe, gen_params={})


# ------------------------------------------------- --exported_dir (artifacts)
ART_ARGV = ["--subject", "s", "--clothes1", "a", "--clothes2", "b", "--random_init"]


class _Built(Exception):
    """Stops JAX's TryOnSystem.__init__ once its artifact is built, before
    its full-width JAX init."""


@pytest.fixture
def stub_artifacts(monkeypatch):
    """Both packages' ArtifactPipeline stubbed: each records the directory
    and scheduler it is built with and every call (the port's cond images
    moved to NHWC). JAX's raises _Built once made. Returns {"jax": [...],
    "port": [...]} of ("made", dir, scheduler) and ("call", record)."""
    from edgestyle_tpu.pipelines import artifact as jartifact

    log = {"jax": [], "port": []}

    class JStub:
        def __init__(self, artifact_dir, scheduler="unipc"):
            log["jax"].append(("made", artifact_dir, scheduler))
            raise _Built

    class Stub:
        latent_shape = (1, 4, 16, 16)

        def __init__(self, artifact_dir, scheduler="unipc", device="cuda"):
            log["port"].append(("made", artifact_dir, scheduler))

        def __call__(self, params, ids, neg, cond, generator=None, latents=None, **kw):
            log["port"].append(("call", {
                "cond": [c.numpy().transpose(0, 2, 3, 1) for c in cond], "ids": np.asarray(ids),
                "latents": latents.numpy().transpose(0, 2, 3, 1),
                "seed": generator.initial_seed(), **kw}))
            b, _, h, w = cond[0].shape
            return torch.zeros((b, 3, h, w))

    monkeypatch.setattr(jartifact, "ArtifactPipeline", JStub)
    monkeypatch.setattr(tryon, "ArtifactPipeline", Stub)
    return log


def _port_system(argv):
    args = tryon.apply_serving_mode(tryon.parse_args(argv))
    pipe = EdgeStylePipeline(dataclasses.replace(TINY_PIPE, scheduler=args.scheduler),
                             device="cpu", tome=args.tome)
    return tryon.TryOnSystem(args=args, device="cpu", pipe=pipe, gen_params={})


@pytest.mark.parametrize("flags", [[], ["--scheduler", "dpm++"]])
def test_exported_dir_builds_an_artifact_pipeline(stub_artifacts, tmp_path, flags):
    """With --exported_dir both packages' TryOnSystem build an
    ArtifactPipeline of the directory with the CLI's scheduler; the port's
    generates one request through it (the same cond images, ids, seed's
    latents and steps as its live path hands the pipeline), and refuses
    generate_batch with JAX's ValueError."""
    from edgestyle_tpu.apps import tryon as japp

    argv = ART_ARGV + ["--exported_dir", str(tmp_path)] + flags
    with pytest.raises(_Built):
        japp.TryOnSystem(args=japp.parse_args(argv))
    system = _port_system(argv)
    assert stub_artifacts["port"] == stub_artifacts["jax"] == [
        ("made", str(tmp_path), "dpm++" if flags else "unipc")]
    rng = np.random.default_rng(5)
    cond = {k: rng.random((32, 32, 3)).astype(np.float32) for k in COND_KEYS}
    ids = rng.integers(1, 99, (1, 7))
    out = system.generate(cond, ids, ids, steps=6, guidance=4.5, seed=7)
    assert out.shape == (32, 32, 3)
    (_, call), = stub_artifacts["port"][1:]
    assert call["seed"] == 7 and call["num_inference_steps"] == 6
    assert call["guidance_scale"] == 4.5 and call["latents"].shape == (1, 16, 16, 4)
    draw = torch.randn((1, 4, 16, 16), generator=make_generator(7, "cpu"))
    np.testing.assert_array_equal(call["latents"][0], draw.numpy()[0].transpose(1, 2, 0))
    np.testing.assert_array_equal(call["cond"][0][0], cond["agnostic"] * 2 - 1)
    jsys = japp.TryOnSystem.__new__(japp.TryOnSystem)
    jsys.pipe, jsys._live_pipe = object(), object()
    with pytest.raises(ValueError) as jerr:
        jsys.generate_batch([cond], ids, ids, seeds=(7,))
    with pytest.raises(ValueError) as err:
        system.generate_batch([cond], ids, ids, seeds=(7,))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("flags", [["--controlnet_cache_interval", "2"], ["--mode", "turbo"],
                                   ["--cfg_interval", "0", "0.5"], ["--tome", "0.5"]])
def test_knob_on_a_per_stage_artifact_raises_like_jax(stub_artifacts, tmp_path, flags):
    """A serving knob with a per-stage artifact directory (no generate
    program) raises JAX's ValueError before any artifact is loaded; beside
    a generate program the artifact is built and checks the knobs itself."""
    from edgestyle_tpu.apps import tryon as japp

    argv = ART_ARGV + ["--exported_dir", str(tmp_path)] + flags
    with pytest.raises(ValueError) as jerr:
        japp.TryOnSystem(args=japp.parse_args(argv))
    with pytest.raises(ValueError) as err:
        _port_system(argv)
    assert str(err.value) == str(jerr.value)
    assert stub_artifacts == {"jax": [], "port": []}
    (tmp_path / "generate.stablehlo").write_bytes(b"")
    (tmp_path / "generate.pt2").write_bytes(b"")
    with pytest.raises(_Built):
        japp.TryOnSystem(args=japp.parse_args(argv))
    _port_system(argv)
    assert stub_artifacts["port"] == stub_artifacts["jax"]


def test_serve_max_batch_with_exported_dir_exits_like_jax(tmp_path):
    """serve --max_batch 2 --exported_dir exits with JAX's message before
    anything is built."""
    argv = ["--random_init", "--max_batch", "2", "--exported_dir", str(tmp_path)]
    with pytest.raises(SystemExit) as jerr:
        jserve.main(argv)
    with pytest.raises(SystemExit) as err:
        serve.main(argv, device="cpu")
    assert str(err.value) == str(jerr.value) and "single-request" in str(err.value)

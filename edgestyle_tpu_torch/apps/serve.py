"""The try-on server: an HTTP front with dynamic batching, and the Gradio callbacks.

Counterpart of edgestyle_tpu/apps/serve.py (the reference's app.py on
:7860):

  * a stdlib HTTP server: ``GET /healthz``, ``POST /tryon`` with a JSON body
    of base64 images (``subject``, ``clothes1``, ``clothes2``; optional
    ``steps``, ``guidance``, ``seed``, ``prompt``, ``negative_prompt``) ->
    a PNG, 400 with a JSON error for a bad payload;
  * with ``--max_batch`` > 1, :class:`BatchingTryOn`: concurrent requests
    coalesce into one generation (``TryOnSystem.generate_batch``), grouped
    by step count, their photos preprocessed in one batched pose and SAM
    pass;
  * :class:`GradioCallbacks`, the reference's two-step preprocess / try-on
    flow without its UI; ``main`` mounts a Gradio app only where ``gradio``
    is importable.

All device work runs on one thread: the batcher's worker, or a handler
under the lock. int8 serving follows ``EDGESTYLE_QUANT`` and
``--int8_scales`` (apps/tryon.py::TryOnSystem).

    python3 -m edgestyle_tpu_torch.apps.serve --random_init --port 7860 --max_batch 2
"""

from __future__ import annotations

import argparse
import base64
import collections
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from edgestyle_tpu_torch.apps.tryon import add_model_source_args, add_serving_args
from edgestyle_tpu_torch.core.device import DeviceLike

log = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle try-on server (PyTorch/CUDA)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)  # reference Dockerfile:21
    p.add_argument("--random_init", action="store_true")
    add_model_source_args(p)
    p.add_argument("--tokenizer_dir", type=str, default=None,
                   help="CLIP tokenizer files (vocab.json/merges.txt); without it prompts "
                        "fall back to the BOS/EOS empty encoding")
    p.add_argument("--clip_model", type=str, default=None,
                   help="CLIPModel safetensors directory: per-request prompt mining from the "
                        "first clothes photo")
    p.add_argument("--prompt", type=str, default=None,
                   help="default prompt; a request's 'prompt' overrides it; None -> mined "
                        "(with --clip_model) or empty")
    p.add_argument("--negative_prompt", type=str,
                   default="monochrome, lowres, bad anatomy, worst quality, low quality")
    p.add_argument("--use_agnostic_images", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--steps", type=int, default=None,
                   help="denoise steps (default 20; --mode lcm: 4)")
    p.add_argument("--guidance", type=float, default=3.5)
    add_serving_args(p)
    p.add_argument("--max_batch", type=int, default=1,
                   help=">1: concurrent requests coalesce into one batched generation")
    p.add_argument("--batch_window_ms", type=float, default=50.0,
                   help="how long the batcher waits for more requests after the first")
    return p.parse_args(argv)


def encode_prompts(tokenizer, miner, prompt, negative, clothes01):
    """(prompt_ids, negative_ids), (1, 77) int arrays, for one request.

    No tokenizer: the empty prompt's BOS/EOS encoding (not zeros: id 0 is
    '!'), and a request's own prompt is refused rather than ignored. No
    prompt but a miner: mined from the clothes photo, as the reference app
    does."""
    from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids

    if tokenizer is None:
        if prompt:
            raise ValueError("server started without --tokenizer_dir: a per-request 'prompt' "
                             "is unsupported (it would be silently ignored)")
        e = np.asarray(empty_prompt_ids())
        return e, e
    if prompt is None and miner is not None:
        prompt = miner(clothes01[None])[0]
    return np.asarray(tokenizer([prompt or ""])), np.asarray(tokenizer([negative or ""]))


def _png(arr01: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((arr01 * 255).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _read_image(data: bytes) -> np.ndarray:
    from PIL import Image

    from edgestyle_tpu_torch.data.transforms import standard_image

    with Image.open(io.BytesIO(data)) as im:
        return standard_image(np.asarray(im.convert("RGB"))).astype(np.float32) / 255.0


class TryOnHandler(BaseHTTPRequestHandler):
    system = None  # set by build_server
    tokenizer = None
    miner = None
    batcher = None  # BatchingTryOn when --max_batch > 1
    defaults = {"steps": 20, "guidance": 3.5, "prompt": None, "negative_prompt": ""}
    lock = threading.Lock()

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, json.dumps({"ok": True}).encode(), "application/json")
        else:
            self.send_response(404)
            self.end_headers()

    def do_POST(self):
        if self.path != "/tryon":
            self.send_response(404)
            self.end_headers()
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length))
            subject = _read_image(base64.b64decode(payload["subject"]))
            c1 = _read_image(base64.b64decode(payload["clothes1"]))
            c2 = _read_image(base64.b64decode(payload["clothes2"]))
            steps = int(payload.get("steps", self.defaults["steps"]))
            guidance = float(payload.get("guidance", self.defaults["guidance"]))
            seed = int(payload.get("seed", 0))
            prompt = payload.get("prompt", self.defaults["prompt"])
            negative = payload.get("negative_prompt", self.defaults["negative_prompt"])
            if self.batcher is not None:
                # the batcher's worker does the device work; concurrent
                # requests coalesce into one generation
                out = self.batcher.submit(subject, c1, c2, prompt, negative, steps, guidance,
                                          seed)
            else:
                with self.lock:  # one request at a time on the card, mining included
                    ids, neg = encode_prompts(self.tokenizer, self.miner, prompt, negative, c1)
                    out = self.system(subject, c1, c2, ids, neg, steps, guidance, seed)
            self._send(200, _png(out), "image/png")
        except Exception as e:  # noqa: BLE001 -- report to the client, keep serving
            self._send(400, json.dumps({"error": str(e)}).encode(), "application/json")


class BatchingTryOn:
    """Dynamic request batching for the HTTP front.

    The worker collects up to ``max_batch`` queued requests within
    ``window_s`` of the first, preprocesses the window's photos in one
    batched pass (``prepare_cond_batch``; if that raises, a warning is
    logged and each request falls back to ``prepare_cond``, once), groups
    the requests by step count and runs one ``generate_batch`` per group,
    with per-request guidance and seeds. A failing generation fails its
    group, never the worker; a request whose own preparation raises fails
    alone. All device work (mining, preprocessing, generation) happens on
    the worker thread; handler threads only decode and wait."""

    def __init__(self, system, tokenizer=None, miner=None, max_batch: int = 4,
                 window_s: float = 0.05):
        self.system = system
        self.tokenizer = tokenizer
        self.miner = miner
        self.max_batch = max_batch
        self.window_s = window_s
        self.q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, subject, c1, c2, prompt, negative, steps, guidance, seed):
        """Blocking: the [0, 1] float image of this request."""
        req = {"subject": subject, "c1": c1, "c2": c2, "prompt": prompt,
               "negative": negative, "steps": int(steps), "guidance": float(guidance),
               "seed": int(seed), "done": threading.Event()}
        self.q.put(req)
        req["done"].wait()
        if "error" in req:
            raise req["error"]
        return req["out"]

    def _collect(self):
        batch = [self.q.get()]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self.q.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _prepare_batch(self, rs) -> None:
        """Batched preprocessing of ``rs`` into each request's "cond"; on
        failure a one-line warning, and the requests keep no cond (each then
        takes ``prepare_cond`` in :meth:`_run_group`)."""
        if len(rs) < 2 or not hasattr(self.system, "prepare_cond_batch"):
            return
        try:
            conds = self.system.prepare_cond_batch([r["subject"] for r in rs],
                                                   [r["c1"] for r in rs], [r["c2"] for r in rs])
        except Exception as e:  # noqa: BLE001 -- fall back to per-request preprocessing
            log.warning("batched preprocessing of %d requests failed (%s: %s); preprocessing "
                        "each alone", len(rs), type(e).__name__, e)
            return
        for r, c in zip(rs, conds):
            r["cond"] = c

    def _worker(self):
        while True:
            batch = self._collect()
            # one pose pass and one SAM pass for the whole window, across
            # step groups: steps only split the generation
            self._prepare_batch(batch)
            groups = collections.defaultdict(list)
            for r in batch:
                groups[r["steps"]].append(r)
            for steps, rs in groups.items():
                self._run_group(steps, rs)

    def _run_group(self, steps: int, rs) -> None:
        """One generation for the requests of one step count. A request whose
        own preparation (prompt, preprocessing) raises gets its error and
        leaves the group; a failing generation fails the requests it held."""
        ready = []
        for r in rs:
            try:
                r["ids"], r["neg"] = encode_prompts(self.tokenizer, self.miner, r["prompt"],
                                                    r["negative"], r["c1"])
                if "cond" not in r:
                    r["cond"] = self.system.prepare_cond(r["subject"], r["c1"], r["c2"])
                ready.append(r)
            except Exception as e:  # noqa: BLE001 -- fail this request, not its group
                r["error"] = RuntimeError(f"{type(e).__name__}: {e}")
                r["done"].set()
        if not ready:
            return
        try:
            out = self.system.generate_batch(
                [r["cond"] for r in ready], np.concatenate([r["ids"] for r in ready]),
                np.concatenate([r["neg"] for r in ready]), steps=steps,
                guidance=[r["guidance"] for r in ready], seeds=[r["seed"] for r in ready])
            for j, r in enumerate(ready):
                r["out"] = out[j]
        except Exception as e:  # noqa: BLE001 -- fail the requests, not the worker
            for r in ready:
                # one exception per request: re-raising one shared instance
                # from several threads mixes their tracebacks
                r["error"] = RuntimeError(f"{type(e).__name__}: {e}")
        finally:
            for r in ready:
                r["done"].set()


def _build_prompt_stack(args, device: DeviceLike = "cuda"):
    tokenizer = miner = None
    if getattr(args, "tokenizer_dir", None):
        from edgestyle_tpu_torch.data.tokenizer import CLIPTokenizer

        tokenizer = CLIPTokenizer.from_pretrained_dir(args.tokenizer_dir)
        if getattr(args, "clip_model", None):
            from edgestyle_tpu_torch.data.prompts import build_prompt_miner

            miner = build_prompt_miner(args.tokenizer_dir, args.clip_model, device=device)
    return tokenizer, miner


def build_server(args, system, device: DeviceLike = "cuda") -> ThreadingHTTPServer:
    """The HTTP server on ``args.host``:``args.port`` (0 picks a free port)
    over ``system`` (a TryOnSystem, or anything with its methods)."""
    handler = type("BoundTryOnHandler", (TryOnHandler,), {})
    handler.system = system
    handler.tokenizer, handler.miner = _build_prompt_stack(args, device)
    handler.batcher = None
    if getattr(args, "max_batch", 1) > 1:
        handler.batcher = BatchingTryOn(system, handler.tokenizer, handler.miner,
                                        max_batch=args.max_batch,
                                        window_s=getattr(args, "batch_window_ms", 50.0) / 1e3)
    handler.defaults = {"steps": args.steps if args.steps is not None else 20,
                        "guidance": args.guidance, "prompt": getattr(args, "prompt", None),
                        "negative_prompt": getattr(args, "negative_prompt", "")}
    return ThreadingHTTPServer((args.host, args.port), handler)


def main(argv=None, device: DeviceLike = "cuda") -> None:
    """Build the TryOnSystem and serve: Gradio where it is importable, the
    HTTP front otherwise."""
    from edgestyle_tpu_torch.apps.tryon import TryOnSystem

    args = parse_args(argv)
    if args.max_batch > 1 and getattr(args, "exported_dir", None):
        raise SystemExit(
            "--max_batch > 1 requires the live pipeline; artifact serving "
            "(--exported_dir) is single-request")
    system = TryOnSystem(random_init=args.random_init, args=args, device=device)
    try:
        import gradio  # noqa: F401
    except ImportError:
        srv = build_server(args, system, device)
        print(f"serving on http://{args.host}:{srv.server_address[1]} (POST /tryon, "
              f"GET /healthz)", flush=True)
        srv.serve_forever()
        return
    _launch_gradio(args, system, device)


class GradioCallbacks:
    """The reference's Gradio two-step flow (app.py:125-256) without its UI:

      preprocess(subject, cloth1, cloth2) -> six uint8 conditioning images
        (agnostic or head, subject pose, clothes 1, pose 1, clothes 2, pose 2);
      try_on(six images, scale, steps[, prompt, seed]) -> the uint8 try-on
        image, the prompt mined from the first clothes image when none is
        given and a miner is loaded.
    """

    def __init__(self, system, tokenizer=None, miner=None, default_prompt=None,
                 negative_prompt=""):
        self.system = system
        self.tokenizer = tokenizer
        self.miner = miner
        self.default_prompt = default_prompt
        self.negative_prompt = negative_prompt

    @staticmethod
    def _to01(img_u8):
        from edgestyle_tpu_torch.data.transforms import standard_image

        return standard_image(np.asarray(img_u8)).astype(np.float32) / 255.0

    @staticmethod
    def _to_u8(img01):
        return (np.clip(np.asarray(img01), 0.0, 1.0) * 255).astype(np.uint8)

    def preprocess(self, subject, cloth1, cloth2):
        outs = []
        # the subject slot holds the head crop unless --use_agnostic_images
        # (the reference's preprocess returns the head image, app.py:133,217)
        subj_key = "agnostic" if self.system.use_agnostic else "head"
        for img, key in ((subject, subj_key), (cloth1, "clothes"), (cloth2, "clothes")):
            img01 = self._to01(img)
            kp, skel = self.system.detect_pose(img01)
            outs.append((self.system.extract(img01, kp)[key], skel))
        (a, pa), (c1, p1), (c2, p2) = outs
        return tuple(self._to_u8(x) for x in (a, pa, c1, p1, c2, p2))

    def try_on(self, agnostic, subject_pose, clothes1, clothes1_pose, clothes2, clothes2_pose,
               scale, steps, prompt=None, seed=42):
        c1_01 = np.asarray(clothes1, np.float32) / 255.0
        ids, neg = encode_prompts(self.tokenizer, self.miner, prompt or self.default_prompt,
                                  self.negative_prompt, c1_01)
        cond = {"agnostic": np.asarray(agnostic, np.float32) / 255.0,
                "subject_pose": np.asarray(subject_pose, np.float32) / 255.0,
                "clothes1": c1_01,
                "clothes1_pose": np.asarray(clothes1_pose, np.float32) / 255.0,
                "clothes2": np.asarray(clothes2, np.float32) / 255.0,
                "clothes2_pose": np.asarray(clothes2_pose, np.float32) / 255.0}
        out = self.system.generate(cond, ids, neg, steps=int(steps), guidance=float(scale),
                                   seed=int(seed))
        return self._to_u8(out)


def _launch_gradio(args, system, device: DeviceLike):  # pragma: no cover -- gradio is absent
    import gradio as gr

    tokenizer, miner = _build_prompt_stack(args, device)
    cb = GradioCallbacks(system, tokenizer, miner, default_prompt=args.prompt,
                         negative_prompt=args.negative_prompt)
    with gr.Blocks(title="EdgeStyle") as demo:
        with gr.Row():
            inp = [gr.Image(label="Subject"), gr.Image(label="Clothes 1"),
                   gr.Image(label="Clothes 2")]
        btn_pre = gr.Button("Preprocess")
        with gr.Row():
            conds = [gr.Image(label=n) for n in ("agnostic", "subject pose", "clothes 1",
                                                  "pose 1", "clothes 2", "pose 2")]
        scale = gr.Slider(1.0, 12.0, value=args.guidance, step=0.1, label="Guidance Scale")
        steps = gr.Slider(1, 100, value=args.steps or 20, step=1, label="Inference Steps")
        btn_go = gr.Button("Try On")
        result = gr.Image(label="Result")
        btn_pre.click(cb.preprocess, inputs=inp, outputs=conds)
        btn_go.click(cb.try_on, inputs=conds + [scale, steps], outputs=[result])
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()

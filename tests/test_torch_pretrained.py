"""The port's checkpoint loaders (edgestyle_tpu_torch/core/safetensors.py,
core/pretrained.py, the models' diffusers/HF mappers, the trainer's
safetensors export) against the safetensors package, the JAX package's
mappers and loaders, the committed mirror goldens and transformers, on the
CPU in fp32 (bf16 where a dtype rule is held) at the MID sizes of
tests/golden_mirror.py. Weights are made from seeds; nothing is downloaded.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import CLIPTextConfig as HFConfig
from transformers import CLIPTextModel, CLIPTextModelWithProjection as HFWithProjection

from edgestyle_tpu.core import porting as jporting
from edgestyle_tpu.core import pretrained as jpretrained
from edgestyle_tpu.models import clip_text as jclip
from edgestyle_tpu.models.unet import port_controlnet_state_dict as j_port_controlnet
from edgestyle_tpu.models.unet import port_unet_state_dict as j_port_unet
from edgestyle_tpu.models.vae import port_vae_state_dict as j_port_vae
from edgestyle_tpu.training import checkpoint as jcheckpoint
from edgestyle_tpu_torch.apps import train as train_app
from edgestyle_tpu_torch.core import pretrained, safetensors
from edgestyle_tpu_torch.core.device import make_generator
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params, tree_from_flat
from edgestyle_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextModelWithProjection,
    port_clip_text_state_dict,
)
from edgestyle_tpu_torch.models.multicontrolnet import fusion_block
from edgestyle_tpu_torch.models.unet import (
    SD15UNet,
    UNetConfig,
    port_controlnet_state_dict,
    port_unet_state_dict,
)
from edgestyle_tpu_torch.models.vae import AutoencoderKL, VAEConfig, port_vae_state_dict
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig
from edgestyle_tpu_torch.training import checkpoint
from edgestyle_tpu_torch.training.train_step import init_trainable
from tests import golden_mirror as gm
from tests import torch_sd15
from tests.test_torch_goldens import scaled_close, t
from tests.test_torch_training import TRAIN_CFG
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

CL = torch.channels_last
# CLIP text towers at the MID UNet's cross-attention width (and at
# TRAIN_CFG's), written from HF's own module
MID_CLIP = dict(vocab_size=128, hidden_size=gm.UNET_MID["cross_attention_dim"], num_layers=2,
                num_heads=4, max_positions=16, intermediate_size=192)
MID_PIPE = PipelineConfig(
    unet=UNetConfig(**gm.UNET_MID, cond_embedding_channels=gm.CN_COND_CH),
    vae=VAEConfig(block_out_channels=gm.VAE_MID["chs"], layers_per_block=gm.VAE_MID["layers"],
                  sample_size=gm.VAE_MID["px"]),
    clip=CLIPTextConfig(**MID_CLIP), dtype="float32")


def hf_clip(c, with_projection=False, seed=0):
    cfg = HFConfig(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                   intermediate_size=c["intermediate_size"], num_hidden_layers=c["num_layers"],
                   num_attention_heads=c["num_heads"],
                   max_position_embeddings=c["max_positions"], hidden_act="quick_gelu",
                   eos_token_id=2, projection_dim=c.get("projection_dim", 768))
    torch.manual_seed(seed)
    return (HFWithProjection if with_projection else CLIPTextModel)(cfg).eval()


def clip_manifest(c) -> dict:
    return {k: list(v.shape) for k, v in hf_clip(c).state_dict().items()
            if not k.endswith("position_ids")}


def synth(manifest, seed=1234) -> dict:
    return {k: torch.from_numpy(v) for k, v in gm.synth_state_dict(manifest, seed).items()}


def assert_trees_equal(got, want, what=""):
    """Same keys; each leaf bitwise equal, of the same dtype and memory
    format (4-D leaves channels_last, the rest contiguous)."""
    got, want = flatten(got), flatten(want)
    assert got.keys() == want.keys(), (what, sorted(set(got) ^ set(want))[:6])
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        assert torch.equal(g, w), (what, k)
        assert g.is_contiguous(memory_format=CL if g.ndim == 4 else torch.contiguous_format), k


# ------------------------------------------------------- (a) the format
def _tensors():
    g = torch.Generator().manual_seed(5)
    return {
        "f32": torch.randn((3, 5), generator=g),
        "f16": torch.randn((4,), generator=g).half(),
        "bf16": torch.randn((2, 3, 2), generator=g).bfloat16(),
        "i64": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
        "i32": torch.arange(5, dtype=torch.int32),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
        "conv": torch.randn((4, 3, 3, 3), generator=g).contiguous(memory_format=CL),
    }


@pytest.mark.parametrize("writer", ["package", "port"])
def test_safetensors_round_trip_with_the_package(tmp_path, writer):
    """A file written by either side reads back on the other bitwise, with
    its dtypes, shapes and ``__metadata__``."""
    st = pytest.importorskip("safetensors.torch")
    from safetensors import safe_open

    ts, meta = _tensors(), {"format": "pt", "note": "seeded"}
    path = str(tmp_path / "x.safetensors")
    if writer == "package":
        st.save_file({k: v.contiguous() for k, v in ts.items()}, path, metadata=meta)
        got, got_meta = safetensors.load_file(path), safetensors.read_header(path)[1]
    else:
        assert safetensors.save_file(ts, path, metadata=meta) == os.path.getsize(path)
        got = st.load_file(path)
        with safe_open(path, "pt") as f:
            got_meta = f.metadata()
    assert got_meta == meta
    assert got.keys() == ts.keys()
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0  # the header is padded


def _malformed(tmp_path, case):
    path = str(tmp_path / f"{case}.safetensors")
    safetensors.save_file({"a": torch.ones(4), "b": torch.ones(2)}, path)
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    if case == "overlap":
        header["b"]["data_offsets"] = [8, 16]
        header["a"]["data_offsets"] = [0, 16]
    elif case == "past_end":
        header["a"]["data_offsets"] = [16, 32]
    elif case == "size":
        header["a"]["shape"] = [5]
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob + raw[8 + n:])
    return path


@pytest.mark.parametrize("case", ["overlap", "past_end", "size"])
def test_safetensors_reader_refuses_malformed_files(tmp_path, case):
    with pytest.raises(ValueError, match={"overlap": "overlap", "past_end": "past the end",
                                          "size": "needs"}[case]):
        safetensors.load_file(_malformed(tmp_path, case))


# --------------------------------------------------------- (b) mappers
def _fusion_sd():
    """The fusion manifest as a down block (index 11) and the mid block."""
    m = gm.load_shapes()["fusion"]
    return gm.synth_state_dict({f"{p}.{k}": v for p in ("multi_controlnet_down_blocks.11",
                                                         "multi_controlnet_mid_block")
                                for k, v in m.items()})


def _mapper_case(name):
    """(numpy diffusers/HF state dict, JAX flat mapper, port flat mapper)."""
    if name == "fusion":
        return (_fusion_sd(), lambda sd: jporting.flatten(jpretrained.port_fusion_state_dict(sd)),
                pretrained.port_fusion_state_dict)
    if name == "clip":
        sd = {k: v.numpy() for k, v in hf_clip(MID_CLIP).state_dict().items()}
        return (sd, lambda s: jclip.port_clip_text_state_dict(s, MID_CLIP["num_layers"]),
                lambda s: port_clip_text_state_dict(s, MID_CLIP["num_layers"]))
    fns = {"unet_mid": (j_port_unet, port_unet_state_dict),
           "cn_mid": (j_port_controlnet, port_controlnet_state_dict),
           "vae_mid": (j_port_vae, port_vae_state_dict)}[name]
    return (gm.synth_state_dict(gm.load_shapes()[name]),) + fns


@pytest.mark.parametrize("name", ["unet_mid", "cn_mid", "vae_mid", "fusion", "clip"])
def test_mapper_matches_jax_mapper_and_from_jax_params(name):
    """The port's mapper and tree_from_flat against the JAX mapper and
    from_jax_params, in bf16: the same keys, every leaf bitwise equal, the
    same dtypes (norms fp32) and memory formats."""
    sd, jmap, pmap = _mapper_case(name)
    want = from_jax_params(jporting.unflatten(jmap(sd)), "cpu", torch.bfloat16)
    got = tree_from_flat(pmap({k: torch.from_numpy(v) for k, v in sd.items()}), "cpu",
                         torch.bfloat16)
    assert_trees_equal(got, want, name)


@pytest.mark.parametrize("name,key", [
    ("unet_mid", "down_blocks.0.resnets.0.conv3.weight"),
    ("vae_mid", "encoder.down_blocks.4.resnets.0.conv1.weight"),
    ("clip", "text_model.encoder.layers.2.mlp.fc1.weight"),
])
def test_mapper_refuses_an_unmatched_key(name, key):
    sd, _, pmap = _mapper_case(name)
    with pytest.raises(KeyError, match="unported"):
        pmap({**sd, key: np.zeros((2, 2), np.float32)})


# ---------------------------------------------- (c) loaders vs goldens
def write_dir(path, sd, name="diffusion_pytorch_model.safetensors", dtype=None):
    os.makedirs(path, exist_ok=True)
    safetensors.save_file({k: v if dtype is None else v.to(dtype) for k, v in sd.items()},
                          os.path.join(path, name))
    return str(path)


@pytest.fixture(scope="module")
def goldens():
    return dict(np.load(gm.GOLDENS_NPZ))


@pytest.mark.parametrize("model", ["unet", "controlnet", "vae"])
@torch.no_grad()
def test_loader_reproduces_mirror_golden(tmp_path, goldens, model):
    """Each loader from a safetensors directory written by the port's writer
    (no JAX on the weight path), fp32, through the port's model against
    mirror_v1.npz at tests/test_torch_goldens.py's tolerances."""
    shapes = gm.load_shapes()
    lat, ts, ctx = (t(a) for a in gm.unet_inputs())
    if model == "unet":
        p = pretrained.load_unet_params(write_dir(tmp_path, synth(shapes["unet_mid"])), "cpu",
                                        torch.float32)
        unet = SD15UNet(UNetConfig(**gm.UNET_MID))
        scaled_close(unet(p, lat, ts, ctx), goldens["unet_mid.out"], 1e-4, "unet")
    elif model == "controlnet":
        p = pretrained.load_controlnet_params(write_dir(tmp_path, synth(shapes["cn_mid"])),
                                              "cpu", torch.float32)
        cn = SD15UNet(MID_PIPE.unet, controlnet_mode=True)
        emb = cn.embed_cond(p, t(gm.controlnet_inputs()))
        down, mid = cn.controlnet_forward(p, lat, ts, ctx, emb, conditioning_scale=0.7)
        for i, d in enumerate(down):
            scaled_close(d, goldens[f"cn_mid.down{i}"], 1e-4, f"down{i}")
        scaled_close(mid, goldens["cn_mid.mid"], 1e-4, "mid")
    else:
        p = pretrained.load_vae_params(write_dir(tmp_path, synth(shapes["vae_mid"])), "cpu",
                                       torch.float32)
        vae = AutoencoderKL(MID_PIPE.vae)
        mean, _ = vae.encode_moments(p, t(gm.vae_inputs()))
        moments = goldens["vae_mid.moments"]
        scaled_close(mean, moments[:, :moments.shape[1] // 2], 5e-4, "vae mean")
        scaled_close(vae.decode(p, t(moments[:, :moments.shape[1] // 2])),
                     goldens["vae_mid.decode"], 5e-4, "vae decode")


@torch.no_grad()
def test_fusion_loader_reproduces_mirror_golden(goldens):
    """The reference fusion block's torch state dict through the port's
    fusion mapper (no re-layout of the grouped 1x1s or the LayerNorm)."""
    sd = {f"multi_controlnet_mid_block.{k}": v for k, v in
          synth(gm.load_shapes()["fusion"]).items()}
    p = tree_from_flat(pretrained.port_fusion_state_dict(sd), "cpu")["multi_controlnet_mid_block"]
    out = fusion_block(p, t(gm.fusion_inputs()).permute(0, 2, 3, 1), gm.FUSION["c"],
                       gm.FUSION["n"], torch.float32)
    scaled_close(out.permute(0, 3, 1, 2), goldens["fusion.out"], 1e-5, "fusion")


# ------------------------------- (d, e) the pipeline and the trained set
def seeded_trainables(pipe, unet, seed=7):
    """init_trainable's structure with conv adapters (rank 4), every leaf
    redrawn from a seed so that the ups and heads are not zero."""
    tr = init_trainable(pipe, make_generator(0, "cpu"), unet, 4, lora_conv_rank=1)
    g = torch.Generator().manual_seed(seed)
    return unflatten({k: (0.1 * torch.randn(v.shape, generator=g)).contiguous(
        memory_format=CL if v.ndim == 4 else torch.contiguous_format)
        for k, v in flatten(tr).items()})


@pytest.fixture(scope="module")
def mid_dirs(tmp_path_factory):
    """MID diffusers/HF directories (CLIP fp16, as the public SD1.5 file; the
    UNet fp32, since the JAX loader merges the adapters in the file's dtype
    and the port in the compute dtype; the VAE and the ControlNet fp32) and
    the seeded trained set as a reference-layout directory and as a flat
    file."""
    root = tmp_path_factory.mktemp("mid")
    shapes = gm.load_shapes()
    write_dir(root / "sd" / "unet", synth(shapes["unet_mid"]))
    write_dir(root / "sd" / "text_encoder", synth(clip_manifest(MID_CLIP)),
              "model.safetensors", torch.float16)
    write_dir(root / "vae", synth(shapes["vae_mid"]))
    write_dir(root / "cn", synth(shapes["cn_mid"]))
    pipe = EdgeStylePipeline(MID_PIPE, device="cpu")
    unet = pretrained.load_unet_params(str(root / "sd" / "unet"), "cpu", torch.float32)
    tr = seeded_trainables(pipe, unet)
    pretrained.export_reference_layout(str(root / "ref"), tr)
    checkpoint.export_safetensors(str(root / "flat.safetensors"), tr)
    return root, pipe, tr


@pytest.mark.parametrize("ckpt", ["ref", "flat.safetensors"])
def test_load_pipeline_params_matches_jax_loader(mid_dirs, ckpt):
    """load_pipeline_params at MID with --edgestyle_checkpoint as a
    reference-layout directory and as a flat file, against from_jax_params
    of the JAX loader's tree: leaves bitwise, but the LoRA-merged trunk
    leaves, within 1e-6 of their largest value (merge_lora's product order
    differs); each branch also carries the static net's cond embedding, as
    init_params's tree does. The trained set reads back bitwise, and the
    tree has init_params's keys and shapes."""
    root, pipe, tr = mid_dirs
    args = (str(root / "sd"), str(root / "vae"), str(root / "cn"), str(root / ckpt))
    got = flatten(pretrained.load_pipeline_params(*args, pipe=pipe))
    ref = flatten(pipe.init_params(make_generator(0, "cpu")))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    want = flatten(from_jax_params(jax.tree.map(np.asarray, jpretrained.load_pipeline_params(
        *args)), "cpu"))
    for key in ("lora_0", "lora_1"):
        for k in [k for k in got if k[:3] == ("controlnet", key, "controlnet_cond_embedding")]:
            assert got.pop(k) is got[("controlnet", "static") + k[2:]]
    assert got.keys() == want.keys()
    unet = {k[1:]: v for k, v in got.items() if k[0] == "unet"}
    merged = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k[1] in ("lora_0", "lora_1") and k[2:] in unet and not torch.equal(g, unet[k[2:]]):
            merged += 1
            err = (g - w).abs().max().item()
            assert err <= 1e-6 * w.abs().max().item(), (k, err)
        else:
            assert torch.equal(g, w), k
    assert merged > 0
    back = (pretrained.load_edgestyle_pretrained_dir(args[-1], "cpu") if ckpt == "ref"
            else checkpoint.import_safetensors(args[-1], "cpu"))
    assert_trees_equal(back, tr, ckpt)


def test_load_pipeline_params_without_checkpoint(mid_dirs):
    """No trained set: fresh adapters and fusion from the generator, zero
    heads; the branch trunks equal the UNet's (zero ups), dtypes by the
    rules (bf16 pipeline: norms fp32, the rest bf16)."""
    root, _, _ = mid_dirs
    pipe = EdgeStylePipeline(dataclasses.replace(MID_PIPE, dtype="bfloat16"), device="cpu")
    p = pretrained.load_pipeline_params(str(root / "sd"), str(root / "vae"), str(root / "cn"),
                                        pipe=pipe, generator=make_generator(3, "cpu"))
    ref = pipe.init_params(make_generator(0, "cpu"))
    assert {k: (v.shape, v.dtype) for k, v in flatten(p).items()} == {
        k: (v.shape, v.dtype) for k, v in flatten(ref).items()}
    for k, v in flatten(p["controlnet"]["lora_0"]).items():
        if k[0].startswith("controlnet_") and k[0] != "controlnet_cond_embedding":
            assert not v.any(), k
        elif k[0] != "controlnet_cond_embedding":
            assert torch.equal(v, flatten(p["unet"])[k]), k
    assert flatten(p["controlnet"]["fusion"])[
        ("multi_controlnet_mid_block", "first_conv", "kernel")].abs().sum() > 0


@pytest.mark.parametrize("kind", ["reference_layout", "flat"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trained_set_round_trips_across_packages(mid_dirs, tmp_path, kind, writer):
    """A trained set with conv adapters written by one package reads back in
    the other bitwise: the port's export_reference_layout /
    export_safetensors against the JAX loaders, the JAX exporters against
    the port's loaders."""
    _, _, tr = mid_dirs
    path = str(tmp_path / ("ref" if kind == "reference_layout" else "t.safetensors"))
    if writer == "port":
        if kind == "reference_layout":
            pretrained.export_reference_layout(path, tr)
            back = jpretrained.load_edgestyle_pretrained_dir(path)
        else:
            checkpoint.export_safetensors(path, tr)
            back = jcheckpoint.import_safetensors(path)
        back = from_jax_params(back, "cpu")
    else:
        jtr = to_jax_params(tr)
        if kind == "reference_layout":
            jpretrained.export_reference_layout(path, jtr)
            back = pretrained.load_edgestyle_pretrained_dir(path, "cpu")
        else:
            jcheckpoint.export_safetensors(path, jtr)
            back = checkpoint.import_safetensors(path, "cpu")
    got, want = flatten(back), flatten(tr)
    assert got.keys() == want.keys()
    assert any(k[-1] == "down" and v.ndim == 4 for k, v in want.items())
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], w), k


# --------------------------------------------------- (f) the projection
@pytest.mark.parametrize("reference", ["jax", "transformers"])
@torch.no_grad()
def test_clip_text_with_projection(reference):
    """CLIPTextModelWithProjection on an HF random-init model's weights
    (through the port's mapper, text_projection by hand as the JAX
    package's load_clip_model_params does) against the JAX module on the
    same weights and against transformers: last hidden state, pooled output
    and text_embeds within 2e-5 (tests/test_clip_text.py's tolerance)."""
    c = dict(vocab_size=1000, hidden_size=64, num_layers=3, num_heads=4, max_positions=77,
             intermediate_size=128, projection_dim=48)
    hf = hf_clip(c, with_projection=True)
    sd = hf.state_dict()
    flat = port_clip_text_state_dict({k: v for k, v in sd.items() if k.startswith("text_model.")},
                                     c["num_layers"])
    flat = {f"text_model.{k}": v for k, v in flat.items()}
    flat["text_projection.kernel"] = sd["text_projection.weight"]
    cfg = CLIPTextConfig(**c)
    ids = np.random.default_rng(9).integers(1, 999, size=(2, 77))
    ids[:, -1] = 999  # the EOS is the largest id, so argmax pooling picks it
    out = CLIPTextModelWithProjection(cfg)(tree_from_flat(flat, "cpu"), torch.from_numpy(ids))
    if reference == "transformers":
        r = hf(torch.from_numpy(ids))
        want = {"last_hidden_state": r.last_hidden_state, "text_embeds": r.text_embeds}
    else:
        jsd = {k: v.numpy() for k, v in sd.items()}
        jflat = {f"text_model.{k}": v for k, v in jclip.port_clip_text_state_dict(
            {k: v for k, v in jsd.items() if k.startswith("text_model.")},
            c["num_layers"]).items()}
        jflat["text_projection.kernel"] = jporting.linear_kernel(jsd["text_projection.weight"])
        jmod = jclip.CLIPTextModelWithProjection(jclip.CLIPTextConfig(**c))
        r = jax.jit(jmod.apply)({"params": jporting.unflatten(jflat)},
                                jnp.asarray(ids.astype(np.int32)))
        want = {k: torch.from_numpy(np.asarray(r[k]))
                for k in ("last_hidden_state", "pooled_output", "text_embeds")}
    assert out["text_embeds"].shape == (2, 48)
    for k, w in want.items():
        np.testing.assert_allclose(out[k].numpy(), w.numpy(), atol=2e-5, err_msg=k)


# ------------------------------------------------------ the trainer's build
def test_train_build_loads_weight_directories(tmp_path):
    """build() with base_cfg=TRAIN_CFG and no --random_init loads the three
    directories (written at TRAIN_CFG's widths from the diffusers-keyed
    mirrors of tests/torch_sd15.py and HF's CLIPTextModel): its frozen
    weights are the loader's, its trainables have a random-init build's
    structure."""
    u = TRAIN_CFG.unet
    cfg = dict(block_out_channels=u.block_out_channels, layers_per_block=u.layers_per_block,
               cross_attention_dim=u.cross_attention_dim, num_heads=u.num_heads)
    with torch.device("meta"):
        mods = {"unet": torch_sd15.UNet2DConditionModel(cfg),
                "cn": torch_sd15.ControlNetModel(cfg, u.cond_embedding_channels),
                "vae": torch_sd15.AutoencoderKL(TRAIN_CFG.vae.block_out_channels,
                                                layers=TRAIN_CFG.vae.layers_per_block)}
    shapes = {k: {n: list(v.shape) for n, v in m.state_dict().items()} for k, m in mods.items()}
    clip = dataclasses.asdict(TRAIN_CFG.clip)
    write_dir(tmp_path / "sd" / "unet", synth(shapes["unet"]), dtype=torch.float16)
    write_dir(tmp_path / "sd" / "text_encoder", synth(clip_manifest(clip)), "model.safetensors")
    write_dir(tmp_path / "vae", synth(shapes["vae"]))
    write_dir(tmp_path / "cn", synth(shapes["cn"]))
    flags = ["--resolution", "32", "--controllora_linear_rank", "4", "--mixed_precision", "no"]
    dirs = ["--pretrained_model", str(tmp_path / "sd"), "--vae", str(tmp_path / "vae"),
            "--openpose_controlnet", str(tmp_path / "cn")]
    pipe, frozen, _, state, _ = train_app.build(train_app.parse_args(flags + dirs), "cpu",
                                                TRAIN_CFG)
    params = pretrained.load_pipeline_params(str(tmp_path / "sd"), str(tmp_path / "vae"),
                                             str(tmp_path / "cn"), pipe=pipe)
    assert_trees_equal(frozen, {"vae": params["vae"], "clip": params["clip"],
                                "unet": params["unet"], "static": params["controlnet"]["static"]})
    _, _, _, ref_state, _ = train_app.build(train_app.parse_args(flags + ["--random_init"]),
                                            "cpu", TRAIN_CFG)
    assert {k: v.shape for k, v in flatten(state["trainable"]).items()} == {
        k: v.shape for k, v in flatten(ref_state["trainable"]).items()}

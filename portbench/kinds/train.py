"""ControlLoRA finetune cells: the step function of the port's
``make_train_step``, one optimizer step (``grad_accum`` micro-batches of
``micro_batch`` rows) after another.

Set-up builds one training state (the port's frozen weights through its
converters, the trainables in fp32, Prodigy's state) and the step, and
warms the step up with ``check_steps`` steps on rows of their own, from
that state; the step is functional, so the state is left as it was, and
the window starts from it with the same step. Each step's
batch and random draws (the VAE posterior noise of the target and of the
three VAE conditions, the diffusion noise, the timesteps, the clothes swap
flips) are drawn on the device from the step's own generator, seeded from
the run's seed and the step's index.

The check: the plain fp32 reference follows the window's first
``check_steps`` steps from the same trainables on the same batches and
draws. Compared,
each against its limit: the worst step's loss gap (relative), the first
gradient as the optimizer got it (worked out from Prodigy's first moment
after one step, ``m = d0 (1 - beta1) g``), and the trainables' change
after the checked steps, both by the worst leaf: the gap between the
program's norm of the leaf and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change (they move by round-off alone under Prodigy's normalised
step).
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Dict, List, Optional

import torch

from portbench import weights as weight_maker
from portbench.kinds.tryon import pipeline_config
from portbench.reference import edgestyle as ref
from portbench.reference import train as ref_train
from portbench.roofline import counted_flops

IMAGES = ("original", "agnostic", "head", "clothes", "clothes2")       # in [-1, 1]
POSES = ("original_openpose", "clothes_openpose", "clothes_openpose2")  # in [0, 1]
TRAINABLE = ("fusion", "controlnet_0", "controlnet_1")


def _flat_trainable(w: Dict) -> Dict[str, torch.Tensor]:
    return {f"{g}/{k}": v for g in TRAINABLE for k, v in w["trainable"][g].items()}


def _port_state(w: Dict, cfg: Dict, pipe, device):
    """The port's frozen set and trainables from the benchmark's weights,
    through its converters, with the leaf correspondence {port path:
    reference key}."""
    from edgestyle_tpu_torch.apps.train import bf16_leaves
    from edgestyle_tpu_torch.core.porting import tree_from_flat
    from edgestyle_tpu_torch.core.pretrained import (
        port_controllora_state_dict,
        port_fusion_state_dict,
    )
    from edgestyle_tpu_torch.models.clip_text import port_clip_text_state_dict
    from edgestyle_tpu_torch.models.unet import port_controlnet_state_dict, port_unet_state_dict
    from edgestyle_tpu_torch.models.vae import port_vae_state_dict

    dt = pipe.dtype
    frozen = {"vae": tree_from_flat(port_vae_state_dict(w["vae"]), device, dt),
              "clip": tree_from_flat(port_clip_text_state_dict(
                  w["clip"], cfg["clip"]["num_layers"]), device, dt),
              "unet": tree_from_flat(port_unet_state_dict(w["unet"]), device, dt),
              "static": tree_from_flat(port_controlnet_state_dict(w["controlnet"]), device, dt)}
    if dt == torch.bfloat16:
        frozen = bf16_leaves(frozen)
    tr = w["trainable"]
    names: Dict[str, str] = {}

    def mapped(fn, group):
        # the converter's renames, read off by running it on index tensors
        keys = sorted(tr[group])
        out = fn({k: torch.tensor([i]) for i, k in enumerate(keys)})
        return [{path: keys[int(v)] for path, v in part.items()}
                for part in (out if isinstance(out, tuple) else (out,))]

    (fusion_names,) = mapped(port_fusion_state_dict, "fusion")
    # copies: the program's state is its own, the benchmark's weights stay as made
    trainable = {"fusion": tree_from_flat(
        {p: tr["fusion"][k].clone() for p, k in fusion_names.items()}, device)}
    names.update({"fusion." + p: "fusion/" + k for p, k in fusion_names.items()})
    for i in (0, 1):
        lora_names, head_names = mapped(port_controllora_state_dict, f"controlnet_{i}")
        src = tr[f"controlnet_{i}"]
        trainable[f"lora_{i}"] = tree_from_flat(
            {p: src[k].clone() for p, k in lora_names.items()}, device)
        trainable[f"heads_{i}"] = tree_from_flat(
            {p: src[k].clone() for p, k in head_names.items()}, device)
        names.update({f"lora_{i}." + p: f"controlnet_{i}/" + k for p, k in lora_names.items()})
        names.update({f"heads_{i}." + p: f"controlnet_{i}/" + k
                      for p, k in head_names.items()})
    return frozen, trainable, names


def _by_ref_key(tree: Dict, names: Dict[str, str]) -> Dict[str, torch.Tensor]:
    from edgestyle_tpu_torch.core.params import flatten

    return {names[".".join(k)]: v for k, v in flatten(tree).items()}


def leaf_gap(prog: Dict[str, torch.Tensor], ref_: Dict[str, torch.Tensor],
             keys: List[str]) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's."""
    pn = {k: prog[k].double().norm().item() for k in keys}
    rn = {k: ref_[k].double().norm().item() for k in keys}
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys)


class Cell:
    """One training cell: set-up with its warm-up steps, an optimizer step a
    unit, the check of the window's first steps."""

    rate_metric = "samples_per_s"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.ga, self.mb = traffic["grad_accum"], traffic["micro_batch"]
        self.check_steps = self.min_units = traffic["check_steps"]
        self.weights: Optional[Dict] = None
        self.pipe = self.frozen = self.state = self.step_fn = None

    # ---------------------------------------------------------- inputs
    def request(self, idx: int):
        """Step ``idx``'s batch (grad_accum, micro_batch, ...) and draws,
        one dict per micro-batch."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed((self.seed * 1_000_003 + idx + 1) % (2 ** 63))
        ga, b, s = self.ga, self.mb, cfg["sample_size"]
        batch = {}
        for k in IMAGES:
            batch[k] = torch.rand((ga, b, 3, s, s), generator=gen, device=dev) * 2 - 1
        for k in POSES:
            batch[k] = torch.rand((ga, b, 3, s, s), generator=gen, device=dev)
        n_tok, vocab = cfg["clip"]["max_positions"], cfg["clip"]["vocab_size"]
        batch["input_ids"] = torch.randint(1, vocab - 1, (ga, b, n_tok), generator=gen,
                                           device=dev)
        side = s // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        lat = (b, cfg["vae"]["latent_channels"], side, side)
        draws = [{"vae_eps": torch.randn(lat, generator=gen, device=dev),
                  "cond_eps": torch.randn((3 * b, *lat[1:]), generator=gen, device=dev),
                  "noise": torch.randn(lat, generator=gen, device=dev),
                  "timesteps": torch.randint(0, 1000, (b,), generator=gen, device=dev),
                  "flip": torch.rand((b,), generator=gen, device=dev)
                  < cfg["trainer"]["swap_prob"]} for _ in range(ga)]
        return batch, draws

    def rows(self, idx: int) -> List[Dict[str, torch.Tensor]]:
        """Step ``idx``'s rows, one dict per sample, for the reference."""
        batch, draws = self.request(idx)
        out = []
        for i in range(self.ga):
            d = draws[i]
            for j in range(self.mb):
                row = {k: v[i, j] for k, v in batch.items()}
                row.update(vae_eps=d["vae_eps"][j], noise=d["noise"][j],
                           timesteps=d["timesteps"][j], flip=d["flip"][j],
                           cond_eps=d["cond_eps"][j::self.mb])
                out.append(row)
        return out

    # ---------------------------------------------------------- system
    def train_config(self):
        from edgestyle_tpu_torch.training.train_step import TrainConfig

        t = self.cfg["trainer"]
        return TrainConfig(snr_gamma=t["snr_gamma"], max_grad_norm=t["max_grad_norm"],
                           optimizer="prodigy", learning_rate=t["learning_rate"],
                           adam_beta1=t["betas"][0], adam_beta2=t["betas"][1],
                           adam_epsilon=t["eps"], lr_scheduler="constant",
                           weight_decay=t["weight_decay"], swap_prob=t["swap_prob"],
                           use_agnostic=t["use_agnostic"], grad_accum=self.ga)

    def setup(self, weights: Optional[Dict] = None) -> None:
        """The weights (made from the seed, or ``weights``), the port's
        training state and step, ``check_steps`` warm-up steps from that
        state on rows of their own (requests -1, -2, ...), whose new states
        are dropped."""
        from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
        from edgestyle_tpu_torch.training.train_step import make_optimizer, make_train_step

        marks = [time.perf_counter()]

        def mark():
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            marks.append(time.perf_counter())

        self.weights = weights if weights is not None else weight_maker.make(
            self.cfg, self.seed, self.device)
        mark()
        self.pipe = EdgeStylePipeline(pipeline_config(self.cfg, {"sampler": "unipc"}),
                                      device=self.device)
        self.frozen, trainable, self.names = _port_state(self.weights, self.cfg, self.pipe,
                                                         self.device)
        tcfg = self.train_config()
        self.state = {"trainable": trainable, "opt_state": make_optimizer(tcfg).init(trainable),
                      "step": 0}
        self.step_fn = make_train_step(self.pipe, tcfg)
        mark()
        self.theta0 = trainable
        state = self.state
        for i in range(self.check_steps):
            state, _ = self.step_fn(state, self.frozen, *self.request(-1 - i))
        del state
        mark()
        self.losses = []
        self.setup_parts = {name: b - a for name, a, b in
                            zip(("weights_s", "port_s", "warmup_s"), marks, marks[1:])}

    def run_unit(self, idx: int) -> int:
        """Optimizer step ``idx`` of the window, on rows no other step saw;
        of the first ``check_steps``, what the check reads is kept (the
        states are new tensors, so keeping them costs nothing)."""
        self.state, metrics = self.step_fn(self.state, self.frozen, *self.request(idx))
        if idx < self.check_steps:
            self.losses.append(metrics["loss"])
            if idx == 0:
                self.first_moment = self.state["opt_state"]["exp_avg"]
            if idx == self.check_steps - 1:
                self.theta_n = self.state["trainable"]
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return self.ga * self.mb

    def free(self) -> None:
        self.program = {
            "losses": [float(x) for x in self.losses],
            "grad1": {k: v / (ref_train.D0 * (1 - self.cfg["trainer"]["betas"][0]))
                      for k, v in _by_ref_key(self.first_moment, self.names).items()},
            "theta0": _by_ref_key(self.theta0, self.names),
            "theta_n": _by_ref_key(self.theta_n, self.names)}
        self.pipe = self.frozen = self.state = self.step_fn = self.first_moment = None
        self.theta0 = self.theta_n = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- check
    def reference(self, fp8: bool = False) -> Dict:
        with ref.fp32_exact(), (ref.Fp8Products() if fp8 else contextlib.nullcontext()):
            models = ref.Models(self.weights, self.cfg, self.device)
            trainer = ref_train.Trainer(models, self.cfg)
            tr = {k: v.float() for k, v in _flat_trainable(self.weights).items()}
            out = ref_train.run_steps(trainer, tr, [self.rows(i) for i in
                                                    range(self.check_steps)], self.cfg)
            del models, trainer
        return out

    def gaps(self, n_units: int) -> Dict[str, float]:
        return self.gaps_to(self.reference())

    def as_program(self, r: Dict) -> Dict:
        """A reference run's readings in the program's place (the control)."""
        return {"losses": r["losses"], "grad1": r["grad1"], "theta0": self.program["theta0"],
                "theta_n": r["params"]}

    def gaps_to(self, r: Dict, program: Optional[Dict] = None) -> Dict[str, float]:
        p = self.program if program is None else program
        keys = sorted(r["grad1"])
        g_norm = {k: r["grad1"][k].double().norm().item() for k in keys}
        med = statistics.median(g_norm.values())
        moved = [k for k in keys if g_norm[k] >= 1e-3 * med]
        self.notes = {"leaves": len(keys), "left_out_of_change": len(keys) - len(moved)}
        change_p = {k: p["theta_n"][k].float() - p["theta0"][k].float() for k in moved}
        change_r = {k: r["params"][k] - p["theta0"][k].float() for k in moved}
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(p["losses"], r["losses"])),
                "grad1_gap": leaf_gap(p["grad1"], r["grad1"], keys),
                "change_gap": leaf_gap(change_p, change_r, moved)}

    # ---------------------------------------------------------- flops
    def model_flops_per_item(self) -> float:
        """The plain reference's FLOPs for one sample's forward and backward
        at this cell's shapes, counted on the meta device."""
        meta = torch.device("meta")
        cfg = self.cfg
        w = weight_maker.manifest(cfg)
        tree = {g: {k: torch.empty(s, device=meta) for k, (s, _) in m.items()}
                for g, m in w.items()}
        tree["trainable"] = {g.split(".", 1)[1]: tree.pop(g) for g in list(tree)
                             if g.startswith("trainable.")}
        trainer = ref_train.Trainer(ref.Models(tree, cfg, meta), cfg)
        tr = _flat_trainable(tree)
        s, n_tok = cfg["sample_size"], cfg["clip"]["max_positions"]
        side = s // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        lat = (cfg["vae"]["latent_channels"], side, side)
        row = {k: torch.empty((3, s, s), device=meta) for k in IMAGES + POSES}
        row.update(input_ids=torch.zeros((n_tok,), dtype=torch.long, device=meta),
                   vae_eps=torch.empty(lat, device=meta), noise=torch.empty(lat, device=meta),
                   cond_eps=torch.empty((3, *lat), device=meta), timesteps=500, flip=False)
        return float(counted_flops(trainer.step_grads, tr, [row]))

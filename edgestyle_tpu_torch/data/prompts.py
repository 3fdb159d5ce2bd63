"""Prompt mining: CLIP zero-shot retrieval of colours and clothing items.

Counterpart of edgestyle_tpu/data/prompts.py (the reference's
BestEmbeddings, model/utils.py:647-684): embed the garment photo and the
phrase banks with CLIP, softmax the image-text logits (100 cos) over each
bank, take the top-2 colours and the top-2 items, and emit
"edgestyle, <c1, c2, i1, i2>", the trigger-word prompt the model was
trained with. The banks are the JAX package's, copied word for word (the
port imports nothing of it).

The banks are embedded once per miner; per image the miner runs one 224 px
vision forward and two small products on the miner's device.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModelWithProjection
from edgestyle_tpu_torch.models.clip_vision import (
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    clip_preprocess,
)

TRIGGER_WORD = "edgestyle"

_BASE_COLORS = [
    "black", "white", "gray", "charcoal", "silver", "red", "crimson", "scarlet",
    "maroon", "burgundy", "wine", "brick", "rust", "orange", "tangerine", "coral",
    "salmon", "peach", "apricot", "amber", "yellow", "gold", "mustard", "lemon",
    "cream", "ivory", "beige", "khaki", "tan", "camel", "brown", "chocolate",
    "coffee", "taupe", "olive", "green", "emerald", "forest green", "lime",
    "mint", "sage", "teal", "turquoise", "aqua", "cyan", "sky blue", "blue",
    "navy", "royal blue", "cobalt", "denim", "indigo", "violet", "purple",
    "lavender", "lilac", "plum", "magenta", "fuchsia", "pink", "rose", "blush",
    "hot pink", "pastel pink", "pastel blue", "pastel green", "pastel yellow",
]
_COLOR_MODIFIERS = ["", "light ", "dark ", "bright "]
COLORS: List[str] = [m + c for c in _BASE_COLORS for m in _COLOR_MODIFIERS]

CLOTHING_ITEMS: List[str] = [
    # tops
    "t-shirt", "shirt", "dress shirt", "polo shirt", "henley shirt", "flannel shirt",
    "oxford shirt", "button-down shirt", "linen shirt", "silk shirt", "denim shirt",
    "hawaiian shirt", "rugby shirt", "baseball tee", "ringer tee", "long sleeve shirt",
    "short sleeve shirt", "graphic tee", "striped shirt", "plaid shirt", "peasant top",
    "blouse", "ruffled blouse", "wrap top", "halter top", "off-shoulder top",
    "one-shoulder top", "tank top", "crop top", "tube top", "camisole", "bodysuit",
    "bustier", "corset top", "peplum top", "mesh top", "lace top", "sequin top",
    # knitwear
    "sweater", "pullover", "turtleneck", "mock neck sweater", "v-neck sweater",
    "crewneck sweater", "cable knit sweater", "chunky knit sweater", "mohair sweater",
    "cashmere sweater", "argyle sweater", "fair isle sweater", "cardigan",
    "long cardigan", "cropped cardigan", "shrug", "bolero", "sweatshirt", "hoodie",
    "zip-up hoodie", "cropped hoodie", "fleece pullover", "half-zip pullover",
    "knit vest", "sweater vest",
    # outerwear
    "vest", "puffer vest", "quilted vest", "jacket", "denim jacket",
    "leather jacket", "moto jacket", "bomber jacket", "varsity jacket",
    "track jacket", "utility jacket", "field jacket", "shacket", "blazer",
    "double-breasted blazer", "suit jacket", "tuxedo jacket", "windbreaker",
    "anorak", "raincoat", "trench coat", "overcoat", "topcoat", "duster coat",
    "wool coat", "wrap coat", "cocoon coat", "parka", "puffer jacket",
    "down jacket", "quilted jacket", "peacoat", "duffle coat", "car coat",
    "fur coat", "faux fur coat", "shearling jacket", "fleece jacket",
    "softshell jacket", "ski jacket", "poncho", "cape", "cloak", "kimono",
    "kaftan", "tunic", "smock",
    # dresses & one-pieces
    "dress", "maxi dress", "midi dress", "mini dress", "sundress", "shirt dress",
    "wrap dress", "slip dress", "sheath dress", "shift dress", "a-line dress",
    "bodycon dress", "fit and flare dress", "sweater dress", "pinafore dress",
    "halter dress", "strapless dress", "off-shoulder dress", "cocktail dress",
    "evening gown", "ball gown", "lace dress", "sequin dress", "velvet dress",
    "floral dress", "polka dot dress", "jumpsuit", "romper", "playsuit",
    "overalls", "dungarees", "boiler suit", "co-ord set",
    # bottoms
    "jeans", "skinny jeans", "ripped jeans", "straight leg jeans", "bootcut jeans",
    "flared jeans", "wide leg jeans", "boyfriend jeans", "mom jeans",
    "high-waisted jeans", "trousers", "dress pants", "pleated trousers", "chinos",
    "corduroy pants", "cargo pants", "joggers", "sweatpants", "track pants",
    "leggings", "yoga pants", "palazzo pants", "culottes", "capri pants",
    "paperbag pants", "leather pants", "shorts", "denim shorts", "cargo shorts",
    "bermuda shorts", "bike shorts", "athletic shorts", "pleated shorts",
    "skirt", "mini skirt", "midi skirt", "maxi skirt", "pleated skirt",
    "pencil skirt", "denim skirt", "wrap skirt", "a-line skirt", "tulle skirt",
    "leather skirt", "slit skirt", "skort",
    # sets, sport, sleep & swim
    "suit", "tuxedo", "tracksuit", "sportswear", "jersey", "football jersey",
    "basketball jersey", "uniform", "workwear", "scrubs", "pajamas", "nightgown",
    "bathrobe", "loungewear", "swimsuit", "one-piece swimsuit", "bikini",
    "swim trunks", "rash guard", "wetsuit", "leotard", "unitard",
    # accessories worn on the torso
    "scarf", "shawl", "pashmina", "tie", "bow tie", "suspenders", "apron",
]


def build_text_bank(tokenizer, encode_text_fn: Callable, phrases: Sequence[str],
                    template: str = "{}") -> torch.Tensor:
    """Embed a phrase bank -> L2-normalised (N, D) text features."""
    ids = tokenizer([template.format(p) for p in phrases])
    emb = encode_text_fn(torch.from_numpy(np.asarray(ids, np.int64)))
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def top2(p: torch.Tensor) -> torch.Tensor:
    """Indices of the two largest entries of each row, ties to the lower
    index first (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(p, dim=-1, descending=True, stable=True).indices[..., :2]


class BestEmbeddings:
    """``find_best(pixel_values)`` -> one prompt string per image.

    encode_image_fn: (B, 3, 224, 224) CLIP-normalised -> (B, D) image embeds.
    encode_text_fn:  (N, 77) int64 ids (host) -> (N, D) text embeds.
    Scoring matches the reference: logits = 100 img^ txt^T, a softmax over
    each bank, the top 2 of each (model/utils.py:665-684)."""

    def __init__(self, tokenizer, encode_image_fn, encode_text_fn,
                 colors: Sequence[str] = None, items: Sequence[str] = None):
        self.colors = list(colors or COLORS)
        self.items = list(items or CLOTHING_ITEMS)
        self.encode_image = encode_image_fn
        self.color_bank = build_text_bank(tokenizer, encode_text_fn, self.colors)
        self.item_bank = build_text_bank(tokenizer, encode_text_fn, self.items)

    @torch.no_grad()
    def probs(self, pixel_values):
        """(colour, item) softmax scores, (B, len(colors)) and (B, len(items))."""
        img = self.encode_image(pixel_values).float()
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        pc = torch.softmax(100.0 * img @ self.color_bank.float().T, dim=-1)
        pi = torch.softmax(100.0 * img @ self.item_bank.float().T, dim=-1)
        return pc, pi

    def find_best(self, pixel_values) -> List[str]:
        pc, pi = self.probs(pixel_values)
        ci, ii = top2(pc).cpu().numpy(), top2(pi).cpu().numpy()
        prompts = []
        for b in range(ci.shape[0]):
            terms = [self.colors[ci[b, 0]], self.colors[ci[b, 1]],
                     self.items[ii[b, 0]], self.items[ii[b, 1]]]
            prompts.append(f"{TRIGGER_WORD}, " + ", ".join(terms))
        return prompts


class PromptMiner:
    """The app's miner: raw [0, 1] images -> trigger prompts.

    Owns the tokenizer so callers can also encode the mined prompt
    (reference app.py:163: BestEmbeddings([clothes]) feeds the pipeline)."""

    def __init__(self, tokenizer, best: BestEmbeddings, device: DeviceLike = "cuda"):
        self.tokenizer = tokenizer
        self.best = best
        self.device = resolve_device(device)

    def pixel_values(self, images01) -> torch.Tensor:
        """(B, H, W, 3) host images in [0, 1] -> CLIP's (B, 3, 224, 224)
        on the miner's device."""
        x = torch.from_numpy(np.ascontiguousarray(images01, dtype=np.float32))
        return clip_preprocess(x.permute(0, 3, 1, 2).to(self.device))

    def __call__(self, images01) -> List[str]:
        return self.best.find_best(self.pixel_values(images01))


def build_prompt_miner(tokenizer_dir: str, clip_model_dir: str, dtype=torch.float32,
                       device: DeviceLike = "cuda", text_cfg: CLIPTextConfig = CLIPTextConfig(),
                       vision_cfg: CLIPVisionConfig = CLIPVisionConfig()) -> PromptMiner:
    """Load openai/clip-vit-large-patch14-layout weights (the towers of
    ``text_cfg`` and ``vision_cfg``, ViT-L/14 by default) and tokenizer
    files onto ``device`` and assemble the zero-shot prompt miner (fp32
    towers by default)."""
    dev = resolve_device(device)
    tok, encode_image, encode_text = load_clip_towers(tokenizer_dir, clip_model_dir, dtype, dev,
                                                      text_cfg, vision_cfg)
    return PromptMiner(tok, BestEmbeddings(tok, encode_image, encode_text), dev)


def load_clip_towers(tokenizer_dir: str, clip_model_dir: str, dtype=torch.float32,
                     device: DeviceLike = "cuda", text_cfg: CLIPTextConfig = CLIPTextConfig(),
                     vision_cfg: CLIPVisionConfig = CLIPVisionConfig()):
    """The tokenizer and a CLIPModel directory's two towers on ``device``:
    (tokenizer, encode_image(pixel_values (B, 3, 224, 224) CLIP-normalised)
    -> (B, D), encode_text(ids (N, 77) int64) -> (N, D)), both without
    gradients."""
    from edgestyle_tpu_torch.core.pretrained import load_clip_model_params
    from edgestyle_tpu_torch.data.tokenizer import CLIPTokenizer

    dev = resolve_device(device)
    tok = CLIPTokenizer.from_pretrained_dir(tokenizer_dir)
    params = load_clip_model_params(clip_model_dir, text_cfg.num_layers, vision_cfg.num_layers,
                                    device=dev, dtype=dtype)
    text_m = CLIPTextModelWithProjection(text_cfg, dtype=dtype)
    vis_m = CLIPVisionModelWithProjection(vision_cfg, dtype=dtype)

    @torch.no_grad()
    def encode_text(ids):
        return text_m(params["text"], ids.to(dev))["text_embeds"]

    @torch.no_grad()
    def encode_image(px):
        return vis_m(params["vision"], px)["image_embeds"]

    return tok, encode_image, encode_text


def clip_similarity(encode_image_fn, imgs_a, imgs_b) -> torch.Tensor:
    """Cosine similarity between two image batches: the dataset's pair
    filter (reference dataset_local.py:116-162, keep 0.80-0.90)."""
    ea = encode_image_fn(imgs_a)
    eb = encode_image_fn(imgs_b)
    ea = ea / torch.linalg.vector_norm(ea, dim=-1, keepdim=True)
    eb = eb / torch.linalg.vector_norm(eb, dim=-1, keepdim=True)
    return (ea * eb).sum(dim=-1)

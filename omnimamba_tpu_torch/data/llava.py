"""Instruction data for the understanding (MMU) flow: the port's counterpart of
``omnimamba_tpu/data/llava.py``.

- ``AlignDataset``: caption-only rows, input "{caption}<|endoftext|>",
  labels a copy, right-padded to 381 ids;
- ``FinetuneDataset``: multi-turn rows through the Mamba prompt builder, loss
  only on the gpt turns, <|eot|> appended, right-padded to 449 ids; a turn
  that would pass ``max_length - 1`` ids ends the row;
- ``PaddedCollatorForLanguageModeling``: stacks ids and labels, a zero image
  for text-only rows and ``multimodal_mask`` marking the rows with an image.

Images arrive as raw uint8 (size, size, 3); the towers' resize and
normalisation happen on the device (``data/transforms.dinosiglip_transform``).

What differs from the JAX package (``ROADMAP.md`` Q3, R6):

- a ``.npy`` of uint8 pixels (H, W, 3) is read directly and resized on the
  host by ``resize_uint8`` (PIL's bicubic resize in two ``F.interpolate``
  passes); other files go through PIL, imported where it is used;
- only a file that does not decode gives the dummy (text-only) row; a
  missing PIL raises, naming the file, and so does a missing file (the JAX
  loader turns both into text-only rows without a word);
- ``make_synthetic_llava_json`` writes the images it names (``.npy`` beside
  the JSON), so synthetic rows are multimodal.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Type

import numpy as np
import torch
import torch.nn.functional as F

from omnimamba_tpu_torch.data.prompt_builder import MambaPromptBuilder, PromptBuilder

IGNORE_INDEX = -100


def resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (size, size, 3) as PIL's bicubic resize does
    it: antialiased bicubic along the rows, rounded and clamped to uint8,
    then along the columns (within 2 levels of PIL, which works in fixed
    point)."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    for shape in ((img.shape[0], size), (size, size)):
        x = F.interpolate(x, size=shape, mode="bicubic", antialias=True, align_corners=False)
        x = x.round().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def _decode_with_pil(path: str, size: int) -> Optional[np.ndarray]:
    try:
        from PIL import Image, ImageFile
    except ImportError as e:
        raise ImportError(
            f"{path}: decoding this image needs PIL, which is not installed; install Pillow or "
            "give the images as .npy files of uint8 pixels (H, W, 3)") from e
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB").resize((size, size)), np.uint8)
    except (OSError, SyntaxError, ValueError):  # the file does not decode
        return None


def load_image_uint8(path: str, size: int) -> Optional[np.ndarray]:
    """The image at ``path`` as uint8 (size, size, 3); None where the file
    does not decode (the dummy row). A ``.jpg`` that is missing or does not
    decode is tried once more as the ``.gif`` of the same name."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{path}: expected uint8 pixels (H, W, 3), got {img.dtype} "
                             f"{img.shape}")
        return img if img.shape[:2] == (size, size) else resize_uint8(img, size)
    alt = path.replace("jpg", "gif")
    candidates = [p for p in (path, alt) if os.path.exists(p)]
    if not candidates:
        raise FileNotFoundError(f"image file not found: {path}")
    for candidate in dict.fromkeys(candidates):
        img = _decode_with_pil(candidate, size)
        if img is not None:
            return img
    return None


def _right_padded(ids, labels, max_length: int, pad_token_id: int):
    n = min(max_length, len(ids))
    out_ids = np.full(max_length, pad_token_id, np.int64)
    out_lab = np.full(max_length, IGNORE_INDEX, np.int64)
    out_ids[:n] = np.asarray(ids[:n])
    out_lab[:n] = np.asarray(labels[:n])
    return out_ids, out_lab


class AlignDataset:
    """Caption-only alignment rows: the last turn's text plus the tokenizer's
    eos, labels a copy of the ids."""

    def __init__(self, chat_json: str, image_dir: str, tokenizer, max_length: int = 381,
                 image_size: int = 384):
        self.image_dir = image_dir
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.image_size = image_size
        self.pad_token_id = int(tokenizer.pad_token_id)
        with open(chat_json) as f:
            self.examples = json.load(f)

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict:
        ex = self.examples[idx]
        caption = ex["conversations"][-1]["value"].strip() + self.tokenizer.eos_token
        ids = list(self.tokenizer(caption)["input_ids"])
        input_ids, labels = _right_padded(ids, ids, self.max_length, self.pad_token_id)
        pixels = load_image_uint8(os.path.join(self.image_dir, ex["image"]), self.image_size)
        return {"pixel_values": pixels, "input_ids": input_ids, "labels": labels}

    def get_modality_lengths(self, n_image_patches: int):
        """(is_multimodal, length) per example: word count (``<image>``
        stripped), plus the patch count for rows with an image."""
        out = []
        for ex in self.examples:
            is_mm = "image" in ex
            n_words = sum(len(t["value"].replace("<image>", "").split())
                          for t in ex["conversations"])
            out.append((is_mm, n_image_patches + n_words if is_mm else n_words))
        return out


class FinetuneDataset:
    """Multi-turn instruction rows: human turns ignored, gpt turns
    supervised, ``eot_id`` appended (ignored), right-padded."""

    def __init__(
        self,
        instruct_json: str,
        image_dir: str,
        tokenizer,
        prompt_builder_fn: Type[PromptBuilder] = MambaPromptBuilder,
        max_length: int = 449,
        eot_id: int = 0,
        image_size: int = 384,
        multimodal_only: bool = True,
    ):
        self.image_dir = image_dir
        self.tokenizer = tokenizer
        self.prompt_builder_fn = prompt_builder_fn
        self.max_length = max_length
        self.eot_id = int(eot_id)
        self.image_size = image_size
        self.pad_token_id = int(tokenizer.pad_token_id)
        with open(instruct_json) as f:
            examples = json.load(f)
        self.examples = [e for e in examples if "image" in e] if multimodal_only else examples

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict:
        ex = self.examples[idx]
        builder = self.prompt_builder_fn(model_family="cobra")
        input_ids: List[int] = []
        labels: List[int] = []
        for turn_idx, turn in enumerate(ex["conversations"]):
            msg = builder.add_turn(turn["from"], turn["value"])
            turn_ids = list(self.tokenizer(msg)["input_ids"])
            if len(input_ids) + len(turn_ids) > self.max_length - 1:
                break
            labels.extend([IGNORE_INDEX] * len(turn_ids) if turn_idx % 2 == 0 else turn_ids)
            input_ids.extend(turn_ids)
        input_ids.append(self.eot_id)
        labels.append(IGNORE_INDEX)
        out_ids, out_lab = _right_padded(input_ids, labels, self.max_length, self.pad_token_id)
        pixels = None
        if "image" in ex:
            pixels = load_image_uint8(os.path.join(self.image_dir, ex["image"]), self.image_size)
        return {"pixel_values": pixels, "input_ids": out_ids, "labels": out_lab}

    def get_modality_lengths(self):
        """(is_multimodal, word count) per example."""
        return [("image" in ex, sum(len(t["value"].split()) for t in ex["conversations"]))
                for ex in self.examples]


class PaddedCollatorForLanguageModeling:
    """Stack ids and labels; a zero image for rows without one, and
    ``multimodal_mask`` (B,) marking the rows with an image."""

    def __init__(self, max_length: int, pad_token_id: int, image_size: int = 384):
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.image_size = image_size

    def __call__(self, examples: List[Dict]) -> Dict[str, np.ndarray]:
        s = self.image_size
        return {
            "pixel_values": np.stack([  # raw uint8; each tower's transform on the device
                e["pixel_values"] if e["pixel_values"] is not None else np.zeros((s, s, 3), np.uint8)
                for e in examples]),
            "input_ids": np.stack([e["input_ids"] for e in examples]),
            "labels": np.stack([e["labels"] for e in examples]),
            "multimodal_mask": np.array([e["pixel_values"] is not None for e in examples]),
        }


def get_dataset_and_collator(
    stage: str,
    tokenizer,
    *,
    dataset_root: str = "datasets/",
    prompt_builder_fn: Type[PromptBuilder] = MambaPromptBuilder,
    max_length: int = 449,
    eot_id: int = 0,
    image_size: int = 384,
    annotation_json: Optional[str] = None,
    image_dir: Optional[str] = None,
):
    """(dataset, collator) for ``stage`` (align, finetune, full-finetune),
    with the reference's dataset paths under ``dataset_root`` unless
    ``annotation_json`` / ``image_dir`` are given."""
    collator = PaddedCollatorForLanguageModeling(max_length, tokenizer.pad_token_id, image_size)
    img_dir = image_dir or os.path.join(dataset_root, "llava/")
    if stage == "align":
        ann = annotation_json or os.path.join(
            dataset_root, "llava/share-captioner_coco_lcs_676k_1121.json")
        return AlignDataset(ann, img_dir, tokenizer, max_length, image_size), collator
    if stage in ("finetune", "full-finetune"):
        ann = annotation_json or os.path.join(
            dataset_root, "llava/sharegpt4v_llava_v1_5_lvis4v_lrv_mix1231k.json")
        ds = FinetuneDataset(ann, img_dir, tokenizer, prompt_builder_fn, max_length, eot_id,
                             image_size)
        return ds, collator
    raise ValueError(f"Stage `{stage}` is not supported!")


def make_synthetic_llava_json(
    path: str, n: int = 16, with_images: bool = True, image_shape=(48, 64),
    text_only_every: int = 0,
) -> str:
    """Write ``n`` multi-turn rows of the instruction schema to ``path``. With
    ``with_images`` row i names ``img_{i % 4}.npy``, written beside ``path``
    as uint8 pixels of ``image_shape`` drawn from numpy seed 0; with
    ``text_only_every`` = k, every k-th row (i % k == k - 1) has no image.
    Returns ``path``."""
    rows = []
    for i in range(n):
        row = {
            "conversations": [
                {"from": "human", "value": f"<image>\nWhat is in picture {i}?"},
                {"from": "gpt", "value": f"A synthetic object number {i}."},
                {"from": "human", "value": "Describe its color."},
                {"from": "gpt", "value": "It is a bright test-pattern color."},
            ]
        }
        if with_images and not (text_only_every and i % text_only_every == text_only_every - 1):
            row["image"] = f"img_{i % 4}.npy"
        rows.append(row)
    with open(path, "w") as f:
        json.dump(rows, f)
    if with_images:
        rng = np.random.default_rng(0)
        root = os.path.dirname(os.path.abspath(path))
        for k in range(min(n, 4)):
            np.save(os.path.join(root, f"img_{k}.npy"),
                    rng.integers(0, 256, (*image_shape, 3), dtype=np.uint8))
    return path

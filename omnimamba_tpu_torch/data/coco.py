"""Pretokenized MS-COCO for text-to-image training: the port's counterpart of
``omnimamba_tpu/data/coco.py``.

JSONL rows ``{"captions": [...], "tokens": [256 VQ ids]}``. A training item
is the 256 image ids and the 73-id caption block

    [<|t2i|> <|sot|> | 68 left-padded caption ids | <|eot|> <|soi|> <|eoi|>]

(the model splices the image between <|soi|> and <|eoi|>); an eval item
drops the trailing <|eoi|> (72 ids, the inference prefix) and keeps the
caption. Host-side numpy, no torch; ``make_synthetic_coco_jsonl`` writes rows
of the same schema from a seed.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_CAPTION_TOKENS = 68
NULL_PROMPT = "A picture"  # the null condition of classifier-free guidance


class MSCOCOFeatureDataset:
    """Items (image ids (256,), caption block (73,)); with ``sample_num`` an
    eval set of the first ``sample_num`` shuffled rows, items (caption block
    (72,), caption). The rows are shuffled once by ``random.Random(seed)``,
    which also picks each item's caption (and drops it to ``NULL_PROMPT``
    with ``drop_cond_prob`` in training)."""

    def __init__(
        self,
        data_path: str,
        uni_prompting,
        sample_num: Optional[int] = None,
        drop_cond_prob: float = 0.0,
        seed: int = 0,
    ):
        self.uni_prompting = uni_prompting
        self.pad_token_id = int(uni_prompting.text_tokenizer.pad_token_id)
        sp = uni_prompting.sptids_dict
        self.prefix = np.array([sp["<|t2i|>"], sp["<|sot|>"]], np.int64)
        self.suffix = np.array([sp["<|eot|>"], sp["<|soi|>"], sp["<|eoi|>"]], np.int64)
        self.drop_cond_prob = drop_cond_prob
        self.rng = random.Random(seed)
        self.eval = sample_num is not None
        with open(data_path) as f:
            lines = f.readlines()
        self.rng.shuffle(lines)
        self.lines = lines if sample_num is None else lines[:sample_num]

    def __len__(self) -> int:
        return len(self.lines)

    def _caption_block(self, caption: str) -> np.ndarray:
        ids = np.asarray(self.uni_prompting.text_tokenizer(caption)["input_ids"], np.int64)
        block = np.full(MAX_CAPTION_TOKENS, self.pad_token_id, np.int64)
        n = min(len(ids), MAX_CAPTION_TOKENS)
        if n:
            block[-n:] = ids[:n]  # left padded
        return np.concatenate([self.prefix, block, self.suffix])

    def __getitem__(self, index: int):
        data = json.loads(self.lines[index])
        captions = data["captions"]
        if self.rng.random() < self.drop_cond_prob and not self.eval:
            caption = NULL_PROMPT
        else:
            caption = captions[self.rng.randint(0, len(captions) - 1)]
        block = self._caption_block(caption)
        if self.eval:
            return block[:-1], caption
        return np.asarray(data["tokens"], np.int64), block


def coco_collate(examples: List[Tuple[np.ndarray, np.ndarray]]) -> Dict[str, np.ndarray]:
    """{"inputs": (B, 256) image ids, "caption_ids": (B, 73)}."""
    return {
        "inputs": np.stack([e[0] for e in examples]),
        "caption_ids": np.stack([e[1] for e in examples]),
    }


class MSCOCODatabase:
    """Raw COCO images and their captions from the captions annotation JSON
    ({"images": [...], "annotations": [...]}): items (image (size, size, 3)
    float32 in [-1, 1], NHWC, [caption, ...]). The image is the centre square
    resized by ``data/transforms.center_crop_resize``; decoding needs PIL."""

    def __init__(self, root: str, ann_file: str, size: int = 256):
        self.root = root
        self.size = size
        with open(ann_file) as f:
            ann = json.load(f)
        self.files = {img["id"]: img["file_name"] for img in ann["images"]}
        self.captions: Dict[int, List[str]] = {}
        for a in ann["annotations"]:
            self.captions.setdefault(a["image_id"], []).append(a["caption"])
        self.keys = sorted(self.files)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int):
        from PIL import Image

        from omnimamba_tpu_torch.data.transforms import center_crop_resize

        key = self.keys[index]
        img = Image.open(os.path.join(self.root, self.files[key])).convert("RGB")
        arr = center_crop_resize(np.asarray(img, np.uint8), self.size)
        return arr.astype(np.float32) / 127.5 - 1.0, list(self.captions.get(key, []))


def coco_eval_collate(examples) -> Dict[str, object]:
    """{"caption_ids": (B, 72) prefix ids, "caption": list of str}."""
    return {
        "caption_ids": np.stack([e[0] for e in examples]),
        "caption": [e[1] for e in examples],
    }


def make_synthetic_coco_jsonl(
    path: str, n: int = 64, num_tokens: int = 256, vocab: int = 16384, seed: int = 0
) -> str:
    """Write ``n`` rows of the pretokenized schema, image ids drawn from
    ``seed``; returns ``path``."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            row = {
                "captions": [f"synthetic caption number {i} with objects"],
                "tokens": rng.integers(0, vocab, size=num_tokens).tolist(),
            }
            f.write(json.dumps(row) + "\n")
    return path

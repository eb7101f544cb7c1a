"""UniversalPrompting: per-task sequence packers over the shared tokenizer.
The port's copy of ``omnimamba_tpu/data/prompting.py`` (host-side numpy),
with the same layouts and quirks:

- ``t2i_prompt``: [pad* | <|t2i|> bos text eos] ++ <|soi|> img <|eoi|>,
  the text left-padded to max_text_len+1, cond-dropout to the null prompt
  for classifier-free guidance
- ``t2i_gen_prompt``: the same without labels
- ``lm_prompt``: right-padded LM with eos appended; prepends *eos* (sic)
  when the text does not start with bos; its masks are all ones (sic)
- ``mmu_prompt``: <|mmu|> <|soi|> img <|eoi|> text, labels ignore
  everything through the image
- attention-mask outputs are kept for the interface; the Mamba path ignores
  them
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from omnimamba_tpu_torch.config import SpecialTokens
from omnimamba_tpu_torch.data.tokenizer import add_omnimamba_tokens

IGNORE_ID = -100


class UniversalPrompting:
    def __init__(
        self,
        text_tokenizer,
        special_tokens: Sequence[str] = SpecialTokens().order,
        max_text_len: int = 499,
        ignore_id: int = IGNORE_ID,
        cond_dropout_prob: float = 0.1,
        rng: Optional[np.random.Generator] = None,
    ):
        self.text_tokenizer = text_tokenizer
        self.sptids_dict = add_omnimamba_tokens(
            text_tokenizer, SpecialTokens(order=tuple(special_tokens))
        )
        # +1 because a task token is prepended
        self.max_text_len = max_text_len + 1
        self.pad_id = int(text_tokenizer.pad_token_id)
        self.ignore_id = ignore_id
        self.cond_dropout_prob = cond_dropout_prob
        self.rng = rng or np.random.default_rng(0)

    # ------------------------------------------------------------------
    def _bos(self) -> int:
        return int(self.text_tokenizer.bos_token_id)

    def _eos(self) -> int:
        return int(self.text_tokenizer.eos_token_id)

    def _pack_t2i_text(self, ids: List[int], dropout: bool) -> List[int]:
        if len(ids) == 0:
            ids = [self._bos()]
        elif ids[0] != self._bos():
            ids = [self._bos()] + ids
        temp = [self.sptids_dict["<|t2i|>"]] + ids + [self._eos()]
        if dropout:
            temp = [self.sptids_dict["<|t2i|>"], self._bos(), self._eos()]
        if self.max_text_len >= len(temp):
            temp = [self.pad_id] * (self.max_text_len - len(temp)) + temp
        else:
            temp = temp[: self.max_text_len - 1] + [self._eos()]
        return temp

    def t2i_prompt(
        self, text_ids: List[List[int]], image_ids: np.ndarray, labels: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        seqs, masks, labs = [], [], []
        probs = self.rng.random(len(text_ids))
        soi, eoi = self.sptids_dict["<|soi|>"], self.sptids_dict["<|eoi|>"]
        for i in range(len(text_ids)):
            temp = self._pack_t2i_text(list(text_ids[i]), probs[i] < self.cond_dropout_prob)
            n_img = image_ids.shape[-1]
            mask = [0] * max(0, self.max_text_len - len(temp)) + [1] * (len(temp) + n_img + 3)
            lab = np.concatenate([np.asarray(temp), [soi], labels[i], [eoi]])
            lab = np.where(lab == self.pad_id, self.ignore_id, lab)
            seq = np.concatenate([np.asarray(temp), [soi], image_ids[i], [eoi]])
            seqs.append(seq)
            masks.append(np.asarray(mask[: len(seq)]))
            labs.append(lab)
        return np.stack(seqs), np.stack(masks), np.stack(labs)

    def t2i_gen_prompt(
        self, text_ids: List[List[int]], image_ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        seqs, masks = [], []
        soi, eoi = self.sptids_dict["<|soi|>"], self.sptids_dict["<|eoi|>"]
        for i in range(len(text_ids)):
            temp = self._pack_t2i_text(list(text_ids[i]), dropout=False)
            seq = np.concatenate([np.asarray(temp), [soi], image_ids[i], [eoi]])
            seqs.append(seq)
            masks.append(np.ones(len(seq), np.int64))
        return np.stack(seqs), np.stack(masks)

    def lm_prompt(
        self, text_ids: List[List[int]], max_seq_len: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        seqs, masks, labs = [], [], []
        for ids in text_ids:
            ids = list(ids)
            if len(ids) == 0:
                ids = [self._bos()]
            elif ids[0] != self._bos():
                ids = [self._eos()] + ids  # (sic)
            temp = ids + [self._eos()]
            if max_seq_len >= len(temp):
                lab = temp + [self.ignore_id] * (max_seq_len - len(temp))
                temp = temp + [self.pad_id] * (max_seq_len - len(temp))
                # (sic) the mask is computed AFTER padding temp, so the
                # [0]-suffix is empty and lm masks are all ones
                mask = [1] * len(temp) + [0] * (max_seq_len - len(temp))
            else:
                lab = temp[:max_seq_len]
                temp = temp[:max_seq_len]
                mask = [1] * len(temp)
            seqs.append(np.asarray(temp))
            masks.append(np.asarray(mask))
            labs.append(np.asarray(lab))
        return np.stack(seqs), np.stack(masks), np.stack(labs)

    def mmu_prompt(
        self, image_ids: np.ndarray, text_ids: List[List[int]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        seqs, masks, labs = [], [], []
        max_text_len = self.max_text_len - 1
        mmu, soi, eoi = (
            self.sptids_dict["<|mmu|>"],
            self.sptids_dict["<|soi|>"],
            self.sptids_dict["<|eoi|>"],
        )
        for i in range(len(text_ids)):
            ids = list(text_ids[i])
            if len(ids) == 0:
                ids = [self._bos()]
            elif ids[0] != self._bos():
                ids = [self._eos()] + ids  # (sic)
            temp = ids + [self._eos()]
            n_img = image_ids.shape[-1]
            if max_text_len >= len(temp):
                temp = temp + [self.pad_id] * (max_text_len - len(temp))
                mask = [1] * (len(temp) + n_img + 3)
            else:
                temp = temp[: max_text_len - 1] + [self._eos()]
                mask = [1] * (len(temp) + n_img + 3)
            lab = np.concatenate(
                [
                    [self.ignore_id, self.ignore_id],
                    np.full(n_img, self.ignore_id),
                    [self.ignore_id],
                    np.asarray(temp),
                ]
            )
            lab = np.where(lab == self.pad_id, self.ignore_id, lab)
            seq = np.concatenate([[mmu], [soi], image_ids[i], [eoi], np.asarray(temp)])
            seqs.append(seq)
            masks.append(np.asarray(mask[: len(seq)]))
            labs.append(lab)
        return np.stack(seqs), np.stack(masks), np.stack(labs)

    def lvg_prompt(
        self, text_ids: List[List[int]], image_ids: np.ndarray, labels: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Long-video / generation variant: the layout of t2i_prompt."""
        return self.t2i_prompt(text_ids, image_ids, labels)

    def lvg_gen_prompt(
        self, text_ids: List[List[int]], image_ids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The layout of t2i_gen_prompt."""
        return self.t2i_gen_prompt(text_ids, image_ids)

    # ------------------------------------------------------------------
    def __call__(self, inputs, task: str, padding: bool = True, config=None):
        """Tokenize ``inputs`` and pack them for ``task``."""
        if task == "t2i":
            text_ids = self.text_tokenizer(inputs[0])["input_ids"]
            return self.t2i_prompt(text_ids, inputs[1], inputs[2])
        if task == "t2i_gen":
            text_ids = self.text_tokenizer(inputs[0])["input_ids"]
            return self.t2i_gen_prompt(text_ids, inputs[1])
        if task == "lm":
            text_ids = self.text_tokenizer(inputs[0], truncation=True)["input_ids"]
            return self.lm_prompt(text_ids, inputs[1])
        if task == "mmu":
            text_ids = self.text_tokenizer(inputs[1])["input_ids"]
            return self.mmu_prompt(inputs[0], text_ids)
        if task == "lvg":
            text_ids = self.text_tokenizer(inputs[0])["input_ids"]
            return self.lvg_prompt(text_ids, inputs[1], inputs[2])
        if task == "lvg_gen":
            text_ids = self.text_tokenizer(inputs[0])["input_ids"]
            return self.lvg_gen_prompt(text_ids, inputs[1])
        raise NotImplementedError(task)

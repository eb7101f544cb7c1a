"""Text tokenizer: the port's copy of ``omnimamba_tpu/data/tokenizer.py``.

The model's tokenizer is GPT-NeoX's byte-level BPE; ``UniversalPrompting``
adds ``[PAD]`` and nine specials, giving the id layout (base vocab 50277)

    [PAD]=50277, <|soi|>=50278, <|eoi|>=50279, <|sot|>=50280, <|eot|>=50281,
    <|t2i|>=50282, <|mmu|>=50283, <|soc|>=50284, <|eoc|>=50285, <|lvg|>=50286

and an embedding table of 50288 rows (padded to a multiple of 16). The
offline tokenizer keeps this layout exactly (eos ``<|endoftext|>`` = 0, as in
GPT-NeoX) with a stable hash-based word mapping, so every sequence layout
runs without tokenizer files.

``load_text_tokenizer`` reads tokenizer files from disk only: the port never
asks a model hub. Where the JAX package would take a tokenizer from the
Hugging Face cache, put its ``tokenizer.json`` in a directory and name it in
``$OMNIMAMBA_TOKENIZER_DIR``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Sequence

from omnimamba_tpu_torch.config import SpecialTokens

GPT_NEOX_BASE_VOCAB = 50277
EOS_TOKEN = "<|endoftext|>"
EOS_ID = 0


class OfflineTokenizer:
    """Deterministic whitespace + hash tokenizer with the GPT-NeoX id layout.

    Not a BPE: a stand-in with the same vocabulary geometry and special-token
    handling, so the prompting, data and inference paths run with no files.
    """

    def __init__(self, base_vocab: int = GPT_NEOX_BASE_VOCAB):
        self.base_vocab = base_vocab
        self.eos_token = EOS_TOKEN
        self.eos_token_id = EOS_ID
        self.bos_token_id = EOS_ID
        self.pad_token = None
        self.pad_token_id = None
        self._added: Dict[str, int] = {}
        self.padding_side = "right"
        self.model_max_length = 2048

    # --- HF-compatible surface used by the framework -----------------------
    def __len__(self) -> int:
        return self.base_vocab + len(self._added)

    def add_special_tokens(self, mapping: Dict[str, str]) -> int:
        added = 0
        if "pad_token" in mapping:
            tok = mapping["pad_token"]
            if tok not in self._added:
                self._added[tok] = self.base_vocab + len(self._added)
                added += 1
            self.pad_token = tok
            self.pad_token_id = self._added[tok]
        return added

    def add_tokens(self, tokens: Sequence[str]) -> int:
        added = 0
        for tok in tokens:
            if tok not in self._added:
                self._added[tok] = self.base_vocab + len(self._added)
                added += 1
        return added

    def convert_tokens_to_ids(self, tokens):
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        ids = []
        for t in toks:
            if t in self._added:
                ids.append(self._added[t])
            elif t == EOS_TOKEN:
                ids.append(EOS_ID)
            else:
                ids.append(self._word_id(t))
        return ids[0] if single else ids

    def _word_id(self, word: str) -> int:
        # stable hash into [1, base_vocab): id 0 is reserved for eos
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "big")
        return 1 + (h % (self.base_vocab - 1))

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in text.split():
            if word in self._added:
                ids.append(self._added[word])
            elif word == EOS_TOKEN:
                ids.append(EOS_ID)
            else:
                ids.append(self._word_id(word))
        return ids

    def __call__(self, text, truncation: bool = False, **kw):
        if isinstance(text, str):
            ids = self.encode(text)
            if truncation:
                ids = ids[: self.model_max_length]
            return _Encoding(ids)
        ids_list = [self.encode(t) for t in text]
        if truncation:
            ids_list = [i[: self.model_max_length] for i in ids_list]
        return _Encoding(ids_list)

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        rev = {v: k for k, v in self._added.items()}
        out = []
        for i in list(map(int, ids)):
            if i == EOS_ID:
                if not skip_special_tokens:
                    out.append(EOS_TOKEN)
            elif i in rev:
                if not skip_special_tokens:
                    out.append(rev[i])
            else:
                out.append(f"<w{i}>")
        return " ".join(out)

    def batch_decode(self, batch, **kw):
        return [self.decode(ids, **kw) for ids in batch]


class _Encoding:
    def __init__(self, input_ids):
        self.input_ids = input_ids

    def __getitem__(self, key):
        if key == "input_ids":
            return self.input_ids
        raise KeyError(key)


def _find_local_bpe_dir() -> "str | None":
    """Local tokenizer files (vocab.json + merges.txt, or tokenizer.json):
    ``$OMNIMAMBA_TOKENIZER_DIR`` first, then ``ckpts/tokenizer`` and
    ``data/tokenizer`` under the working directory and the repository."""
    candidates = [os.environ.get("OMNIMAMBA_TOKENIZER_DIR")]
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for base in (os.getcwd(), here):
        candidates += [
            os.path.join(base, "ckpts", "tokenizer"),
            os.path.join(base, "data", "tokenizer"),
        ]
    for d in candidates:
        if not d or not os.path.isdir(d):
            continue
        if os.path.exists(os.path.join(d, "tokenizer.json")) or (
            os.path.exists(os.path.join(d, "vocab.json"))
            and os.path.exists(os.path.join(d, "merges.txt"))
        ):
            return d
    return None


def load_text_tokenizer(model_max_length: int = 2048):
    """The byte-level BPE engine (``data/bpe.py``) on local files where
    ``_find_local_bpe_dir`` finds them, else the offline tokenizer."""
    local = _find_local_bpe_dir()
    if local is not None:
        from omnimamba_tpu_torch.data.bpe import ByteLevelBPETokenizer

        return ByteLevelBPETokenizer.from_dir(local, model_max_length=model_max_length)
    return OfflineTokenizer()


def add_omnimamba_tokens(tokenizer, specials: SpecialTokens = SpecialTokens()):
    """Add ``[PAD]`` and the specials to ``tokenizer`` and return the sptids
    dict {token: id} (ints)."""
    tokenizer.add_special_tokens({"pad_token": specials.pad_token})
    tokenizer.add_tokens(list(specials.order))
    sptids = {tok: int(tokenizer.convert_tokens_to_ids(tok)) for tok in specials.order}
    sptids["<|pad|>"] = int(tokenizer.pad_token_id)
    return sptids


def default_sptids(specials: SpecialTokens = SpecialTokens()) -> "dict[str, int]":
    """The sptids of the GPT-NeoX layout without building a tokenizer: ids
    50277..50286, all below the default ``MambaConfig.padded_vocab_size``."""
    sptids = {tok: GPT_NEOX_BASE_VOCAB + 1 + i for i, tok in enumerate(specials.order)}
    sptids["<|pad|>"] = GPT_NEOX_BASE_VOCAB
    return sptids

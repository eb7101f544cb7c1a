"""Byte-level BPE engine (GPT-2 / GPT-NeoX family): the port's copy of
``omnimamba_tpu/data/bpe.py``.

The model's tokenizer is GPT-NeoX's byte-level BPE with the GPT-2
pre-tokenization pattern. This module implements that algorithm so the port
can tokenize real text from local ``vocab.json`` / ``merges.txt`` (or a
``tokenizer.json``) with no network and no ``tokenizers`` native library.
The pattern needs the ``regex`` package (``\\p{L}``, ``\\p{N}``), which is
imported only when a tokenizer is built or trained, so the rest of the port
runs where ``regex`` is not installed.

Encode pipeline (GPT-2 semantics):
  1. split text on added/special tokens (atomic, never merged into BPE),
  2. pre-tokenize each span with the GPT-2 regex,
  3. map each pre-token's UTF-8 bytes through the bytes<->unicode table,
  4. greedily merge the lowest-ranked adjacent pair per ``merges.txt``,
  5. look up merged symbols in ``vocab.json``.

Decode inverts 5-3 and re-inserts added tokens verbatim.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# GPT-2 pre-tokenization pattern (shared by GPT-NeoX's ByteLevel
# pre-tokenizer; contractions, letter runs, number runs, punctuation runs,
# and whitespace handling that glues a leading space onto the next word).
_PRETOKENIZE = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@functools.lru_cache(maxsize=1)
def _pretokenizer():
    """The compiled pattern; ``regex`` is imported here, at first use."""
    import regex

    return regex.compile(_PRETOKENIZE)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char table.

    Printable ASCII/latin bytes map to themselves; the rest map to
    256+offset codepoints so every byte has a visible, json-safe char.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ByteLevelBPETokenizer:
    """Pure-Python byte-level BPE with the HF-tokenizer surface the
    framework uses (``__len__``, ``add_tokens``, ``__call__``, ``decode``)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        *,
        eos_token: str = "<|endoftext|>",
        model_max_length: int = 2048,
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.padding_side = "right"

        self.eos_token = eos_token
        self.eos_token_id = self.vocab.get(eos_token, 0)
        self.bos_token_id = self.eos_token_id
        self.pad_token: Optional[str] = None
        self.pad_token_id: Optional[int] = None

        # added tokens live above the base vocab and are atomic in encode;
        # the eos token is atomic too even when vocab-resident (prompt
        # builders embed the literal "<|endoftext|>" in text,
        # base_prompter.py:10-72)
        self._added: Dict[str, int] = {}
        self._added_re = None  # a compiled ``regex`` pattern once tokens are added
        self._cache: Dict[str, List[int]] = {}
        self._split = _pretokenizer().findall
        if eos_token in self.vocab:
            self._rebuild_added_re()

    # --- loading ------------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw):
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_tokenizer_json(cls, path: str, **kw):
        """Load a HF ``tokenizer.json`` (the only file gpt-neox-20b ships)."""
        with open(path, encoding="utf-8") as f:
            tj = json.load(f)
        model = tj["model"]
        vocab = model["vocab"]
        merges = [
            tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            for m in model["merges"]
        ]
        tok = cls(vocab, merges, **kw)
        for added in tj.get("added_tokens", []):
            content, idx = added["content"], int(added["id"])
            if content not in tok.vocab:
                tok._added[content] = idx
        if tok._added:
            tok._rebuild_added_re()
        return tok

    @classmethod
    def from_dir(cls, path: str, **kw):
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            return cls.from_tokenizer_json(tj, **kw)
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw
        )

    # --- HF-compatible surface ------------------------------------------------
    def __len__(self) -> int:
        top = max(self._added.values(), default=-1) + 1
        return max(len(self.vocab), top)

    def _atomic_ids(self) -> Dict[str, int]:
        atomic = dict(self._added)
        if self.eos_token in self.vocab:
            atomic.setdefault(self.eos_token, self.vocab[self.eos_token])
        return atomic

    def _rebuild_added_re(self):
        import regex

        toks = sorted(self._atomic_ids(), key=len, reverse=True)
        self._added_re = regex.compile("(" + "|".join(regex.escape(t) for t in toks) + ")")

    def add_special_tokens(self, mapping: Dict[str, str]) -> int:
        added = 0
        if "pad_token" in mapping:
            tok = mapping["pad_token"]
            if tok not in self._added and tok not in self.vocab:
                self._added[tok] = len(self)
                self._rebuild_added_re()
                added += 1
            self.pad_token = tok
            self.pad_token_id = self._added.get(tok, self.vocab.get(tok))
        return added

    def add_tokens(self, tokens: Sequence[str]) -> int:
        added = 0
        for tok in tokens:
            if tok not in self._added and tok not in self.vocab:
                self._added[tok] = len(self)
                added += 1
        if added:
            self._rebuild_added_re()
        return added

    def convert_tokens_to_ids(self, tokens):
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        ids = [
            self._added.get(t, self.vocab.get(t))
            for t in toks
        ]
        return ids[0] if single else ids

    # --- BPE core -------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        """Merge loop on one byte-mapped pre-token."""
        word: Tuple[str, ...] = tuple(token)
        if len(word) == 1:
            return [token]
        pairs = _get_pairs(word)
        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new: List[str] = []
            i = 0
            while i < len(word):
                if word[i] == a and i + 1 < len(word) and word[i + 1] == b:
                    new.append(a + b)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        return list(word)

    def _encode_span(self, text: str) -> List[int]:
        ids: List[int] = []
        for pre in self._split(text):
            cached = self._cache.get(pre)
            if cached is None:
                mapped = "".join(self.byte_encoder[b] for b in pre.encode("utf-8"))
                cached = [self.vocab[s] for s in self._bpe(mapped)]
                if len(self._cache) < 65536:
                    self._cache[pre] = cached
            ids.extend(cached)
        return ids

    def encode(self, text: str) -> List[int]:
        if self._added_re is None:
            return self._encode_span(text)
        atomic = self._atomic_ids()
        ids: List[int] = []
        for part in self._added_re.split(text):
            if not part:
                continue
            if part in atomic:
                ids.append(atomic[part])
            else:
                ids.extend(self._encode_span(part))
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

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        rev_added = {v: k for k, v in self._added.items()}
        out: List[str] = []
        buf: List[str] = []  # pending byte-mapped chars

        def flush():
            if buf:
                text = bytearray(self.byte_decoder[c] for c in "".join(buf)).decode(
                    "utf-8", errors="replace"
                )
                out.append(text)
                buf.clear()

        for i in map(int, ids):
            if i in rev_added:
                flush()
                if not skip_special_tokens:
                    out.append(rev_added[i])
            elif skip_special_tokens and i == self.eos_token_id:
                flush()
            else:
                tok = self.ids_to_tokens.get(i)
                if tok is not None:
                    buf.append(tok)
        flush()
        return "".join(out)

    def batch_decode(self, batch, **kw):
        return [self.decode(ids, **kw) for ids in batch]


class _Encoding:
    def __init__(self, input_ids):
        self.input_ids = input_ids

    def __getitem__(self, key):
        if key == "input_ids":
            return self.input_ids
        raise KeyError(key)


def train_bpe(
    corpus: Iterable[str], vocab_size: int
) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """Minimal byte-level BPE trainer (fixture/bring-up use, not production):
    base vocab = the 256 byte symbols; merges chosen by max pair frequency
    over GPT-2-pre-tokenized words, ties broken lexicographically for
    determinism."""
    be = bytes_to_unicode()
    split = _pretokenizer().findall
    words: Dict[Tuple[str, ...], int] = {}
    for line in corpus:
        for pre in split(line):
            sym = tuple(be[b] for b in pre.encode("utf-8"))
            if sym:
                words[sym] = words.get(sym, 0) + 1

    vocab: Dict[str, int] = {c: i for i, c in enumerate(sorted(be.values()))}
    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size:
        counts: Dict[Tuple[str, str], int] = {}
        for w, c in words.items():
            for i in range(len(w) - 1):
                counts[(w[i], w[i + 1])] = counts.get((w[i], w[i + 1]), 0) + c
        if not counts:
            break
        best = max(counts, key=lambda p: (counts[p], p))
        a, b = best
        merges.append(best)
        vocab[a + b] = len(vocab)
        new_words: Dict[Tuple[str, ...], int] = {}
        for w, c in words.items():
            out: List[str] = []
            i = 0
            while i < len(w):
                if w[i] == a and i + 1 < len(w) and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            t = tuple(out)
            new_words[t] = new_words.get(t, 0) + c
        words = new_words
    return vocab, merges


def save_bpe(vocab: Dict[str, int], merges: List[Tuple[str, str]], out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")

"""The port's host-side text modules against the JAX package's: the offline
tokenizer and its id layout, the byte-level BPE on ``tests/fixtures/mini_bpe``,
``UniversalPrompting``, the conversation templates and the Mamba prompt
builder. Every comparison is exact (ids, arrays, strings)."""

from pathlib import Path

import numpy as np
import pytest

from omnimamba_tpu.data import bpe as jbpe
from omnimamba_tpu.data import conversation as jconv
from omnimamba_tpu.data import prompt_builder as jpb
from omnimamba_tpu.data import prompting as jprompt
from omnimamba_tpu.data import tokenizer as jtok
from omnimamba_tpu_torch.data import bpe as tbpe
from omnimamba_tpu_torch.data import conversation as tconv
from omnimamba_tpu_torch.data import prompt_builder as tpb
from omnimamba_tpu_torch.data import prompting as tprompt
from omnimamba_tpu_torch.data import tokenizer as ttok

MINI_BPE = Path(__file__).resolve().parent / "fixtures" / "mini_bpe"
TEXTS = [
    "What is in this image?",
    "  A photo of a corgi, 2 dogs and 13 cats!  ",
    "USER: How many? ASSISTANT: three<|endoftext|> trailing",
    "café naïve — über 3.14 it's we'll they're",
    "",
    "tabs\tand\nnewlines\n\n end",
]


def test_offline_tokenizer_id_layout():
    j, t = jtok.OfflineTokenizer(), ttok.OfflineTokenizer()
    assert ttok.add_omnimamba_tokens(t) == jtok.add_omnimamba_tokens(j) == ttok.default_sptids()
    assert ttok.default_sptids() == jtok.default_sptids()
    sp = ttok.default_sptids()
    assert sp["<|pad|>"] == 50277 and sp["<|soi|>"] == 50278 and sp["<|lvg|>"] == 50286
    assert len(t) == len(j) == 50287 and t.eos_token_id == 0 and t.pad_token_id == 50277
    for text in TEXTS + ["<|mmu|> <|soi|> [PAD] <|endoftext|> word"]:
        assert t.encode(text) == j.encode(text)
        assert t(text)["input_ids"] == j(text)["input_ids"]
        ids = t.encode(text)
        for skip in (False, True):
            assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
    assert t(TEXTS, truncation=True)["input_ids"] == j(TEXTS, truncation=True)["input_ids"]


@pytest.mark.parametrize("text", TEXTS)
def test_bpe_on_mini_bpe(text):
    j, t = jbpe.ByteLevelBPETokenizer.from_dir(str(MINI_BPE)), tbpe.ByteLevelBPETokenizer.from_dir(str(MINI_BPE))
    assert t.encode(text) == j.encode(text)
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    jtok.add_omnimamba_tokens(j)
    ttok.add_omnimamba_tokens(t)
    marked = f"<|mmu|><|soi|>{text}<|eoi|>[PAD]"
    assert t.encode(marked) == j.encode(marked) and len(t) == len(j)
    for skip in (False, True):
        assert t.decode(t.encode(marked), skip_special_tokens=skip) == j.decode(
            j.encode(marked), skip_special_tokens=skip)


def test_bpe_training_and_tokenizer_json(tmp_path):
    corpus = TEXTS * 3 + ["the cat sat on the mat", "the dog sat on the log"]
    jv, jm = jbpe.train_bpe(corpus, 300)
    tv, tm = tbpe.train_bpe(corpus, 300)
    assert tv == jv and tm == jm
    tbpe.save_bpe(tv, tm, str(tmp_path / "bpe"))
    a = tbpe.ByteLevelBPETokenizer.from_dir(str(tmp_path / "bpe"))
    b = jbpe.ByteLevelBPETokenizer.from_dir(str(tmp_path / "bpe"))
    assert a.encode(corpus[-1]) == b.encode(corpus[-1])


def test_load_text_tokenizer_reads_a_local_directory(monkeypatch):
    """With $OMNIMAMBA_TOKENIZER_DIR set, both packages load the same BPE
    from disk (the JAX loader looks no further)."""
    monkeypatch.setenv("OMNIMAMBA_TOKENIZER_DIR", str(MINI_BPE))
    t, j = ttok.load_text_tokenizer(), jtok.load_text_tokenizer()
    assert isinstance(t, tbpe.ByteLevelBPETokenizer)
    assert t.encode(TEXTS[1]) == j.encode(TEXTS[1])
    monkeypatch.setenv("OMNIMAMBA_TOKENIZER_DIR", str(MINI_BPE / "missing"))
    monkeypatch.chdir(MINI_BPE)  # no ckpts/tokenizer or data/tokenizer beside it
    assert isinstance(ttok.load_text_tokenizer(), ttok.OfflineTokenizer)


def prompting_pair(seed=0):
    return (jprompt.UniversalPrompting(jtok.OfflineTokenizer(), max_text_len=12,
                                       rng=np.random.default_rng(seed)),
            tprompt.UniversalPrompting(ttok.OfflineTokenizer(), max_text_len=12,
                                       rng=np.random.default_rng(seed)))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


CAPTIONS = ["a red bus", "two cats on a very long sofa in the living room at night again and again",
            ""]


@pytest.mark.parametrize("task", ["t2i", "t2i_gen", "lm", "mmu", "lvg", "lvg_gen"])
def test_universal_prompting(task):
    """Every task of the dispatcher, with padding, truncation and (t2i) the
    cond dropout drawn from the same seed."""
    j, t = prompting_pair(1)
    assert t.sptids_dict == j.sptids_dict and t.pad_id == j.pad_id
    rng = np.random.default_rng(2)
    image_ids = rng.integers(0, 100, (3, 5))
    labels = rng.integers(0, 100, (3, 5))
    inputs = {
        "t2i": (CAPTIONS, image_ids, labels), "lvg": (CAPTIONS, image_ids, labels),
        "t2i_gen": (CAPTIONS, image_ids), "lvg_gen": (CAPTIONS, image_ids),
        "lm": (CAPTIONS, 9), "mmu": (image_ids, CAPTIONS),
    }[task]
    for _ in range(3):  # the t2i dropout draws advance in step
        _equal(t(inputs, task), j(inputs, task))


def test_prompting_quirks_and_dropout():
    """The kept quirks: lm and mmu prepend eos (not bos) to text that does
    not start with bos, and lm masks are all ones; the t2i cond dropout
    gives the null prompt."""
    j, t = prompting_pair(3)
    seqs, masks, labs = t.lm_prompt([[5, 6]], 6)
    assert list(seqs[0][:4]) == [0, 5, 6, 0] and masks.all()
    _equal((seqs, masks, labs), j.lm_prompt([[5, 6]], 6))
    seqs, _, _ = t.mmu_prompt(np.zeros((1, 2), np.int64), [[7]])
    assert list(seqs[0][:6]) == [t.sptids_dict["<|mmu|>"], t.sptids_dict["<|soi|>"], 0, 0,
                                 t.sptids_dict["<|eoi|>"], 0]
    always = tprompt.UniversalPrompting(ttok.OfflineTokenizer(), max_text_len=6,
                                        cond_dropout_prob=1.0)
    seqs, _, _ = always.t2i_prompt([[9, 9, 9]], np.zeros((1, 2), np.int64), np.zeros((1, 2), np.int64))
    assert list(seqs[0][-7:-4]) == [always.sptids_dict["<|t2i|>"], 0, 0]


def _prompt_or_error(conv):
    """The prompt, or the type of what it raises (the plain template has no
    second separator: an answered turn raises TypeError in both packages)."""
    try:
        return conv.get_prompt()
    except TypeError as e:
        return type(e)


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_conversation_templates(name):
    for question in ("What is in this image?", "<image>\nDescribe it."):
        prompts = []
        for conv_mod in (jconv, tconv):
            conv = conv_mod.conv_templates[name].copy()
            conv.append_message(conv.roles[0], question)
            conv.append_message(conv.roles[1], None)
            prompts.append(_prompt_or_error(conv))
            conv.messages[-1][1] = "an answer"
            prompts.append(_prompt_or_error(conv))
        assert prompts[:2] == prompts[2:]
    assert set(tconv.conv_templates) == set(jconv.conv_templates)


def test_mamba_prompt_builder():
    turns = [("human", "<image>\nWhat is it?"), ("gpt", "A cat."), ("human", "Color?"), ("gpt", "")]
    j, t = jpb.MambaPromptBuilder("mamba"), tpb.MambaPromptBuilder("mamba")
    for role, msg in turns:
        assert t.add_turn(role, msg) == j.add_turn(role, msg)
        assert t.get_potential_prompt("next?") == j.get_potential_prompt("next?")
    assert t.get_prompt() == j.get_prompt()
    with pytest.raises(ValueError, match="must be 'human'"):
        t.add_turn("gpt", "out of turn")

"""The training data path of the port against the JAX package's, on the CPU:
``center_crop_resize``, the COCO datasets and collates, the LLaVA align and
finetune datasets and their collator (on ``tests/fixtures/mini_bpe``), and
the loaders' batch order over two epochs from one seed. Every comparison is
exact (ids, labels, masks, pixels).

Also the loaders' prefetch threads (a loader ended early returns at once),
and R6, two faults of the reference's LLaVA loader that the port does not
copy, pinned both ways.
"""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from omnimamba_tpu.data import bpe as jbpe
from omnimamba_tpu.data import coco as jcoco
from omnimamba_tpu.data import llava as jllava
from omnimamba_tpu.data import loader as jloader
from omnimamba_tpu.data import prompting as jprompt
from omnimamba_tpu.data import tokenizer as jtok
from omnimamba_tpu.data import transforms as jtr
from omnimamba_tpu_torch.data import bpe as tbpe
from omnimamba_tpu_torch.data import coco as tcoco
from omnimamba_tpu_torch.data import llava as tllava
from omnimamba_tpu_torch.data import loader as tloader
from omnimamba_tpu_torch.data import prompting as tprompt
from omnimamba_tpu_torch.data import tokenizer as ttok
from omnimamba_tpu_torch.data import transforms as ttr

MINI_BPE = Path(__file__).resolve().parent / "fixtures" / "mini_bpe"


def assert_trees_equal(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_trees_equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{what}/{i}")
    elif want is None:
        assert got is None, what
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)


def bpe_pair():
    j = jbpe.ByteLevelBPETokenizer.from_dir(str(MINI_BPE))
    t = tbpe.ByteLevelBPETokenizer.from_dir(str(MINI_BPE))
    jtok.add_omnimamba_tokens(j)
    ttok.add_omnimamba_tokens(t)
    return j, t


def write_png(path, seed, shape=(30, 40)):
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)
    Image.fromarray(img).save(path)
    return img


# ---------------------------------------------------------------------------
# transforms and COCO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [((40, 60, 3), 16), ((61, 37, 3), 24), ((32, 32, 3), 32)])
def test_center_crop_resize_exact(shape, size):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    got = ttr.center_crop_resize(img, size)
    assert_trees_equal(got, jtr.center_crop_resize(img, size))
    assert got.shape == (size, size, 3)


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_coco_items_and_collates_exact(tmp_path, drop):
    """Synthetic JSONL (the same bytes from both writers), training items and
    ``coco_collate``, the eval set (``sample_num``) and ``coco_eval_collate``;
    with ``drop_cond_prob`` both draw the same null captions from one seed."""
    jpath = jcoco.make_synthetic_coco_jsonl(str(tmp_path / "j.jsonl"), n=12, num_tokens=16,
                                            vocab=32, seed=3)
    tpath = tcoco.make_synthetic_coco_jsonl(str(tmp_path / "t.jsonl"), n=12, num_tokens=16,
                                            vocab=32, seed=3)
    assert Path(jpath).read_bytes() == Path(tpath).read_bytes()
    j, t = bpe_pair()
    jup, tup = jprompt.UniversalPrompting(j), tprompt.UniversalPrompting(t)
    jds = jcoco.MSCOCOFeatureDataset(jpath, jup, drop_cond_prob=drop, seed=4)
    tds = tcoco.MSCOCOFeatureDataset(tpath, tup, drop_cond_prob=drop, seed=4)
    assert len(jds) == len(tds) == 12
    items = [(tds[i], jds[i]) for i in range(12)]
    for a, b in items:
        assert_trees_equal(a, b)
        assert a[1].shape == (73,) and a[0].shape == (16,)
    assert_trees_equal(tcoco.coco_collate([a for a, _ in items]),
                       jcoco.coco_collate([b for _, b in items]))
    jev = jcoco.MSCOCOFeatureDataset(jpath, jup, sample_num=5, seed=1)
    tev = tcoco.MSCOCOFeatureDataset(tpath, tup, sample_num=5, seed=1)
    ev = [(tev[i], jev[i]) for i in range(5)]
    assert ev[0][0][0].shape == (72,)
    assert_trees_equal(tcoco.coco_eval_collate([a for a, _ in ev]),
                       jcoco.coco_eval_collate([b for _, b in ev]))


def test_coco_database_exact(tmp_path):
    ann = {"images": [{"id": 7, "file_name": "a.png"}, {"id": 3, "file_name": "b.png"}],
           "annotations": [{"image_id": 7, "caption": "a cat"}, {"image_id": 7, "caption": "x"},
                           {"image_id": 3, "caption": "a dog"}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    write_png(tmp_path / "a.png", 1, (40, 52))
    write_png(tmp_path / "b.png", 2, (33, 21))
    jdb = jcoco.MSCOCODatabase(str(tmp_path), str(tmp_path / "ann.json"), size=16)
    tdb = tcoco.MSCOCODatabase(str(tmp_path), str(tmp_path / "ann.json"), size=16)
    assert len(tdb) == 2
    for i in range(2):
        assert_trees_equal(tdb[i], jdb[i])
    assert tdb[1][1] == ["a cat", "x"] and tdb[0][0].dtype == np.float32


# ---------------------------------------------------------------------------
# LLaVA
# ---------------------------------------------------------------------------


def llava_rows(n_images):
    long_answer = " ".join(["many words in a long answer"] * 12)
    rows = [
        {"image": "img0.png", "conversations": [
            {"from": "human", "value": "<image>\nWhat is this?"},
            {"from": "gpt", "value": "A synthetic test pattern."},
            {"from": "human", "value": "And the colour?"},
            {"from": "gpt", "value": long_answer}]},  # passes max_length - 1: cut there
        {"conversations": [  # text only
            {"from": "human", "value": "Tell me a joke."},
            {"from": "gpt", "value": "No."}]},
        {"image": "img1.png", "conversations": [
            {"from": "human", "value": "<image>\nDescribe."},
            {"from": "gpt", "value": ""}]},
        {"image": "broken.png", "conversations": [  # does not decode: the dummy row
            {"from": "human", "value": "<image>\nAnd this?"},
            {"from": "gpt", "value": "Nothing."}]},
    ]
    return rows[:n_images]


@pytest.fixture()
def llava_dir(tmp_path):
    write_png(tmp_path / "img0.png", 5, (30, 40))
    write_png(tmp_path / "img1.png", 6, (50, 20))
    (tmp_path / "broken.png").write_bytes(b"not an image at all")
    (tmp_path / "rows.json").write_text(json.dumps(llava_rows(4)))
    return tmp_path


@pytest.mark.parametrize("multimodal_only", [True, False])
def test_finetune_items_and_collator_exact(llava_dir, multimodal_only):
    """ids, labels (loss on gpt turns only, <|eot|> appended, the turn that
    passes ``max_length - 1`` dropped), pixels and ``multimodal_mask``."""
    j, t = bpe_pair()
    eot = t.convert_tokens_to_ids("<|eot|>")
    kw = dict(max_length=48, eot_id=eot, image_size=16, multimodal_only=multimodal_only)
    jds = jllava.FinetuneDataset(str(llava_dir / "rows.json"), str(llava_dir), j, **kw)
    tds = tllava.FinetuneDataset(str(llava_dir / "rows.json"), str(llava_dir), t, **kw)
    assert len(tds) == len(jds) == (3 if multimodal_only else 4)
    items = [(tds[i], jds[i]) for i in range(len(tds))]
    for a, b in items:
        assert_trees_equal(a, b)
    first = items[0][0]
    assert (first["labels"] != -100).any() and first["input_ids"][-1] == t.pad_token_id
    assert tds.get_modality_lengths() == jds.get_modality_lengths()
    jcol = jllava.PaddedCollatorForLanguageModeling(48, j.pad_token_id, 16)
    tcol = tllava.PaddedCollatorForLanguageModeling(48, t.pad_token_id, 16)
    got = tcol([a for a, _ in items])
    assert_trees_equal(got, jcol([b for _, b in items]))
    assert got["multimodal_mask"].tolist() == (
        [True, True, False] if multimodal_only else [True, False, True, False])


def test_align_items_exact(llava_dir):
    j, t = bpe_pair()
    rows = [r for r in llava_rows(3) if "image" in r]
    (llava_dir / "align.json").write_text(json.dumps(rows))
    jds, jcol = jllava.get_dataset_and_collator(
        "align", j, max_length=24, image_size=16, annotation_json=str(llava_dir / "align.json"),
        image_dir=str(llava_dir))
    tds, tcol = tllava.get_dataset_and_collator(
        "align", t, max_length=24, image_size=16, annotation_json=str(llava_dir / "align.json"),
        image_dir=str(llava_dir))
    assert isinstance(tds, tllava.AlignDataset) and tds.max_length == 24
    items = [(tds[i], jds[i]) for i in range(len(rows))]
    for a, b in items:
        assert_trees_equal(a, b)
    assert_trees_equal(tcol([a for a, _ in items]), jcol([b for _, b in items]))
    assert tds.get_modality_lengths(729) == jds.get_modality_lengths(729)
    with pytest.raises(ValueError, match="not supported"):
        tllava.get_dataset_and_collator("pretrain", t)


def test_npy_images_resize_like_pil(tmp_path):
    """A ``.npy`` takes the port's own resize: within 2 levels of PIL's
    bicubic on noise, and as it is where it already has the size."""
    from PIL import Image

    img = np.random.default_rng(7).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    np.save(tmp_path / "a.npy", img)
    got = tllava.load_image_uint8(str(tmp_path / "a.npy"), 32).astype(np.int32)
    want = np.asarray(Image.fromarray(img).resize((32, 32)), np.int32)
    assert np.abs(got - want).max() <= 2
    np.save(tmp_path / "b.npy", img[:32, :32])
    assert_trees_equal(tllava.load_image_uint8(str(tmp_path / "b.npy"), 32), img[:32, :32])
    np.save(tmp_path / "c.npy", img.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tllava.load_image_uint8(str(tmp_path / "c.npy"), 32)


# ---------------------------------------------------------------------------
# R6: two faults of the reference's loader, pinned both ways
# ---------------------------------------------------------------------------


def test_r6_synthetic_llava_rows_are_multimodal(tmp_path):
    """R6, fault 2, ``omnimamba_tpu/data/llava.py:246-263``: the JAX
    ``make_synthetic_llava_json(with_images=True)`` names ``img_{i % 4}.jpg``
    files nobody writes, so every synthetic row loads as a text-only row and
    the collated ``multimodal_mask`` is all False. The port's writes its
    ``.npy`` images beside the JSON: every row is multimodal."""
    j, t = bpe_pair()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath = jllava.make_synthetic_llava_json(str(tmp_path / "j" / "rows.json"), n=4)
    tpath = tllava.make_synthetic_llava_json(str(tmp_path / "t" / "rows.json"), n=4)
    jds, jcol = jllava.get_dataset_and_collator("finetune", j, image_size=16,
                                                annotation_json=jpath, image_dir=str(tmp_path / "j"))
    tds, tcol = tllava.get_dataset_and_collator("finetune", t, image_size=16,
                                                annotation_json=tpath, image_dir=str(tmp_path / "t"))
    jbatch, tbatch = jcol([jds[i] for i in range(4)]), tcol([tds[i] for i in range(4)])
    assert not jbatch["multimodal_mask"].any() and not jbatch["pixel_values"].any()
    assert tbatch["multimodal_mask"].all() and tbatch["pixel_values"].any()
    assert_trees_equal(tbatch["input_ids"], jbatch["input_ids"])  # same text either way
    assert_trees_equal(tbatch["labels"], jbatch["labels"])


def test_r6_missing_pil_raises_instead_of_a_dummy_row(llava_dir, monkeypatch):
    """R6, fault 1, ``omnimamba_tpu/data/llava.py:30-46``: the JAX
    ``_load_image_uint8`` catches every ``Exception``, the ``ImportError`` of a
    missing PIL too, so without PIL every image row silently becomes a
    text-only row with a zero image. The port raises, naming the file. A file
    that is missing raises in the port too; a file that does not decode is a
    dummy row in both."""
    path = str(llava_dir / "img0.png")
    assert tllava.load_image_uint8(str(llava_dir / "broken.png"), 16) is None
    assert jllava._load_image_uint8(str(llava_dir / "broken.png"), 16) is None
    with pytest.raises(FileNotFoundError, match="nowhere.png"):
        tllava.load_image_uint8(str(llava_dir / "nowhere.png"), 16)
    assert jllava._load_image_uint8(str(llava_dir / "nowhere.png"), 16) is None
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now raises ImportError
    assert jllava._load_image_uint8(path, 16) is None
    with pytest.raises(ImportError, match="img0.png"):
        tllava.load_image_uint8(path, 16)
    np.save(llava_dir / "img0.npy", np.zeros((8, 8, 3), np.uint8))  # .npy needs no PIL
    assert tllava.load_image_uint8(str(llava_dir / "img0.npy"), 8).shape == (8, 8, 3)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


class _Range:
    def __init__(self, n, offset=0):
        self.n, self.offset = n, offset

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i + self.offset])


def _stack(items):
    return np.concatenate(items)


@pytest.mark.parametrize("threads", [0, 3])
def test_combined_loader_order_over_two_epochs(threads):
    """max_size_cycle over a 5-batch and a 2-batch loader, shuffled from one
    seed, drop_last: the port's batches equal the JAX package's, epoch after
    epoch (the shorter loader's epochs advance as it cycles)."""
    def make(mod):
        return mod.CombinedLoader({
            "t2i_flow": mod.DataLoader(_Range(17), 3, _stack, seed=11, num_threads=max(threads, 1)),
            "mmu_flow": mod.DataLoader(_Range(5, 100), 2, _stack, seed=12, num_threads=max(threads, 1)),
        })

    tl, jl = make(tloader), make(jloader)
    if not threads:
        for dl in tl.iterables.values():
            dl.num_threads = 0
    assert len(tl) == len(jl) == 5
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == 5
        assert_trees_equal(got, want)
    assert tl.iterables["mmu_flow"].epoch == jl.iterables["mmu_flow"].epoch == 6
    keep = tloader.DataLoader(_Range(7), 3, _stack, shuffle=False, drop_last=False)
    assert [b.tolist() for b in keep] == [[0, 1, 2], [3, 4, 5], [6]] and len(keep) == 3
    with pytest.raises(ValueError):
        tloader.CombinedLoader({"t2i_flow": None})


def test_loader_ended_early_returns_and_its_threads_end():
    """A loader whose later items block: taking one batch and closing the
    iterator returns at once (it waits for no thread); once the items are let
    go, every prefetch thread ends."""
    gate = threading.Event()

    class Blocking(_Range):
        def __getitem__(self, i):
            if i >= 2:
                gate.wait(20)
            return super().__getitem__(i)

    before = set(threading.enumerate())
    it = iter(tloader.DataLoader(Blocking(8), 1, _stack, shuffle=False, num_threads=2, prefetch=3))
    try:
        assert next(it).tolist() == [0]
        t0 = time.monotonic()
        it.close()
        assert time.monotonic() - t0 < 1.0
    finally:
        gate.set()
    threads = [th for th in set(threading.enumerate()) - before if th.name == "omt-loader"]
    assert threads and all(th.daemon for th in threads)
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()


def test_loader_raises_the_datasets_error():
    class Broken(_Range):
        def __getitem__(self, i):
            if i == 3:
                raise KeyError("row 3")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="row 3"):
        list(tloader.DataLoader(Broken(6), 2, _stack, shuffle=False, num_threads=2))

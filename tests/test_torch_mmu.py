"""The understanding (MMU) path as a whole: the port's ``mmu_embed_sequence``,
``mmu_image_features`` and ``mmu_generate`` against the JAX package's on the
tiny backbone and the tiny towers, on the CPU; the eos read of the decode
engine; the repetition penalty's image span; ``build_model``.

Greedy token streams must be equal in fp32. Random tiny weights can put two
logits closer together than the arithmetic noise of two frameworks, so where
a stream differs the assertion prints the top-2 margin at the first
differing step. Embeddings and labels are compared exactly (lookups and
concatenation); image features to 2e-5 of the largest value.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.data import transforms as jtr
from omnimamba_tpu.models import generation as jgen
from omnimamba_tpu.models import omnimamba as jom
from omnimamba_tpu.ops.sampling import SampleParams as JSampleParams
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.config import TrainConfig
from omnimamba_tpu_torch.data import transforms as ttr
from omnimamba_tpu_torch.factory import build_model
from omnimamba_tpu_torch.models import generation as tgen
from omnimamba_tpu_torch.models import omnimamba as tom
from omnimamba_tpu_torch.models.backbone import embed_text
from omnimamba_tpu_torch.ops.sampling import SampleParams
from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_helpers import SPTIDS, bridge, fill_lora_b, nn, tiny_mmu_models, tt

FEAT_TOL = 2e-5
N_IMG = 16  # the tiny towers: 56 px in 14 px patches
EOS = 3


@pytest.fixture(scope="module")
def pair():
    """JAX parameters of the tiny model with towers and projector (LoRA B
    filled so the mmu branch counts; LayerScale gammas at 0.5 so the blocks
    count), and their bridged copy."""
    jmodel, tmodel = tiny_mmu_models()
    jp = jom.init_omnimamba(jax.random.PRNGKey(0), jmodel, with_vq=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(0))
    dino = dict(jp["vision"]["dino"])
    blocks = dict(dino["blocks"])
    for k in ("ls1", "ls2"):
        blocks[k] = {"gamma": jnp.full_like(blocks[k]["gamma"], 0.5)}
    dino["blocks"] = blocks
    jp = {"mamba": {**jp["mamba"], "layers": layers},
          "vision": {"dino": dino, "siglip": jp["vision"]["siglip"]},
          "projector": jp["projector"]}
    return jmodel, tmodel, jp, bridge(jp, tmodel)


def raw_images(seed, B):
    return np.random.default_rng(seed).integers(0, 256, (B, 70, 50, 3), dtype=np.uint8)


def features(pair, seed, B):
    """Each side's projected features of the same images."""
    jmodel, tmodel, jp, tp = pair
    raw = raw_images(seed, B)
    jf = jom.mmu_image_features(jp, jmodel, jtr.dinosiglip_transform(jnp.asarray(raw),
                                                                   jmodel.vision_cfg))
    tf = tom.mmu_image_features(tp, tmodel, ttr.dinosiglip_transform(torch.from_numpy(raw),
                                                                    tmodel.vision_cfg))
    return jf, tf


def prompts(seed, B, T):
    """[<|mmu|> <|soi|> <|eoi|> <|sot|>] ++ T text ids (none of them 0 or eos)."""
    text = np.random.default_rng(seed).integers(4, 49, (B, T))
    head = np.array([SPTIDS["<|mmu|>"], SPTIDS["<|soi|>"], SPTIDS["<|eoi|>"], SPTIDS["<|sot|>"]])
    return np.concatenate([np.broadcast_to(head, (B, 4)), text], axis=1)


def test_mmu_image_features(pair):
    jf, tf = features(pair, 1, 2)
    assert tuple(tf.shape) == (2, N_IMG, 32) and tf.dtype == torch.float32
    want = np.asarray(jf)
    np.testing.assert_allclose(nn(tf), want, rtol=0, atol=FEAT_TOL * np.abs(want).max())


def test_mmu_embed_sequence(pair):
    jmodel, tmodel, jp, tp = pair
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 49, (2, 6))
    labels = rng.integers(0, 49, (2, 6))
    feats = rng.standard_normal((2, N_IMG, 32)).astype(np.float32)
    je, jl = jom.mmu_embed_sequence(jp, jmodel, jnp.asarray(ids), jnp.asarray(feats),
                                    jnp.asarray(labels), dtype=jnp.float32)
    te, tl = tom.mmu_embed_sequence(tp, tmodel, tt(ids), tt(feats), tt(labels),
                                    dtype=torch.float32)
    assert tuple(te.shape) == (2, 4 + N_IMG + 6, 32)
    np.testing.assert_array_equal(nn(te), np.asarray(je))
    np.testing.assert_array_equal(nn(tl), np.asarray(jl))
    te16, no_labels = tom.mmu_embed_sequence(tp, tmodel, tt(ids), tt(feats))
    assert no_labels is None and te16.dtype == torch.bfloat16
    np.testing.assert_array_equal(nn(tom._mmu_wrap_ids(SPTIDS, tt(ids))),
                                  np.asarray(jom._mmu_wrap_ids(SPTIDS, jnp.asarray(ids))))


def assert_streams_equal(got, want, logits, what):
    got, want = nn(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.array_equal(got, want):
        return
    b, pos = np.argwhere(got != want)[0]
    step = pos - (got.shape[1] - len(logits))
    top2 = torch.topk(logits[step][b], 2).values
    raise AssertionError(
        f"{what}: streams differ first at row {b} position {pos}: {got[b, pos]} vs "
        f"{want[b, pos]}; top-2 logit margin there {float(top2[0] - top2[1]):.3e}")


def j_generate(pair, ids, jf, max_length, eos=EOS, **kw):
    jmodel, _, jp, _ = pair
    return jom.mmu_generate(jp, jmodel, jnp.asarray(ids), jf, max_length=max_length,
                            dtype=jnp.float32, cache_dtype=None, eos_token_id=eos, **kw)


def t_generate(pair, ids, tf, max_length, eos=EOS, **kw):
    _, tmodel, _, tp = pair
    return tom.mmu_generate(tp, tmodel, ids, tf, max_length=max_length, dtype=torch.float32,
                            cache_dtype=None, eos_token_id=eos, device="cpu", **kw)


# name: (batch, text ids, new tokens, eos, port keywords). "plain" takes the
# default decode path; "near_table_end" decodes without eos past the
# 128-entry mmu position table (prompt 27, 120 new), where decode clamps to
# the table's last row
CASES = {
    "plain": (2, 5, 12, EOS, {}),
    "fused": (2, 5, 12, EOS, dict(decode_impl="fused")),
    "scan": (2, 5, 12, EOS, dict(decode_impl="scan")),
    "near_table_end": (1, 6, 120, None, dict(decode_impl="fused")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mmu_generate_streams(pair, case):
    B, T, new, eos, kw = CASES[case]
    ids = prompts(3, B, T)
    jf, tf = features(pair, 4, B)
    L = ids.shape[1] + N_IMG + new
    ref = j_generate(pair, ids, jf, L, eos=eos)
    got = t_generate(pair, ids, tf, L, eos=eos, return_logits=True, **kw)
    assert got.num_generated == int(ref.num_generated) == (new if eos is None else got.num_generated)
    assert_streams_equal(got.sequences, ref.sequences, got.logits, f"mmu {case}")
    # the image span of the ids holds zeros, as in the JAX package
    assert int(got.sequences[:, 2:2 + N_IMG].abs().max()) == 0


def test_mmu_generate_ragged(pair):
    """Right-padded rows with their true text lengths: each row's stream is
    the JAX package's ragged stream and its own B=1 stream."""
    ids = prompts(5, 3, 7)
    lengths = np.array([11, 7, 9])  # the 4 specials included
    for i, n in enumerate(lengths):
        ids[i, n:] = SPTIDS["<|pad|>"]
    jf, tf = features(pair, 6, 3)
    L = ids.shape[1] + N_IMG + 10
    ref = j_generate(pair, ids, jf, L, text_lengths=jnp.asarray(lengths))
    got = t_generate(pair, ids, tf, L, text_lengths=lengths, return_logits=True)
    assert_streams_equal(got.sequences, ref.sequences, got.logits, "mmu ragged")
    for i, n in enumerate(lengths):
        # a row alone stops at its own eos; the batch runs on for the others
        solo = t_generate(pair, ids[i:i + 1, :n], tf[i:i + 1], n + N_IMG + 10)
        k = solo.num_generated
        np.testing.assert_array_equal(nn(solo.sequences[0, n + N_IMG:n + N_IMG + k]),
                                      nn(got.sequences[i, ids.shape[1] + N_IMG:][:k]))


@pytest.mark.parametrize("draft", ["layers", "ngram"])
def test_mmu_generate_speculative(pair, draft):
    ids = prompts(7, 1, 6)
    jf, tf = features(pair, 8, 1)
    L = ids.shape[1] + N_IMG + 14
    kw = dict(draft_layers=1, k_draft=4) if draft == "layers" else dict(draft_mode="ngram", k_draft=4)
    ref = j_generate(pair, ids, jf, L, **kw)
    got = t_generate(pair, ids, tf, L, **kw)
    plain = t_generate(pair, ids, tf, L, return_logits=True)
    assert got.num_generated == int(ref.num_generated)
    assert_streams_equal(got.sequences, ref.sequences, plain.logits, f"speculative {draft} vs JAX")
    assert_streams_equal(got.sequences, plain.sequences, plain.logits, f"speculative {draft} vs plain")
    with pytest.raises(ValueError, match="ragged"):
        t_generate(pair, ids, tf, L, text_lengths=[10], **kw)
    with pytest.raises(ValueError, match="repetition penalty"):
        t_generate(pair, ids, tf, L, sample=SampleParams(top_k=1, repetition_penalty=1.2), **kw)


# ---------------------------------------------------------------------------
# P3: the eos test copies each token to the host and reads it one step later
# ---------------------------------------------------------------------------

NEW = 12  # generated steps of the P3 test


def embedded(pair, ids, feats_seed):
    """Each side's spliced prompt (ids with a zero image span, embeddings)."""
    jmodel, tmodel, jp, tp = pair
    jf, tf = features(pair, feats_seed, ids.shape[0])
    B = ids.shape[0]
    splice = np.concatenate([ids[:, :2], np.zeros((B, N_IMG), ids.dtype), ids[:, 2:]], axis=1)
    from omnimamba_tpu.models.backbone import embed_text as j_embed_text

    je = j_embed_text(jp["mamba"], jnp.asarray(ids), jnp.float32)
    je = jnp.concatenate([je[:, :2], jf, je[:, 2:]], axis=1)
    te = embed_text(tp["mamba"], tt(ids), torch.float32)
    te = torch.cat([te[:, :2], tf, te[:, 2:]], dim=1)
    return splice, je, te


@pytest.mark.parametrize("stop", [1, 2, NEW - 2, NEW - 1, NEW, None])
def test_eos_stop_read_one_step_late(pair, stop, monkeypatch):
    """A teacher stream puts eos in every row at generated step ``stop``
    (one row gave eos earlier, which stops nothing): ``sequences`` (zeros
    after the stop), ``num_generated`` and the logits equal the JAX
    package's and a read after every token's. The watch reads a step's
    tokens once the next step is queued, so the decode steps run are the
    stop's (one past it), or all of them."""
    jmodel, tmodel, jp, tp = pair
    ids = prompts(9, 2, 5)
    splice, je, te = embedded(pair, ids, 10)
    L0 = splice.shape[1]
    teacher = np.random.default_rng(11).integers(4, 49, (2, L0 + NEW))
    teacher[1, L0] = EOS
    if stop is not None:
        teacher[:, L0 + stop - 1] = EOS
    ref = jgen.generate(jp["mamba"], jmodel.cfg, input_ids=jnp.asarray(splice),
                        input_embeddings=je, task="mmu", max_length=L0 + NEW,
                        sample=JSampleParams(top_k=1), eos_token_id=EOS,
                        teacher_outputs=jnp.asarray(teacher), cache_dtype=None)
    common = dict(input_ids=tt(splice), input_embeddings=te, task="mmu", max_length=L0 + NEW,
                  sample=SampleParams(top_k=1), eos_token_id=EOS, teacher_outputs=tt(teacher),
                  cache_dtype=None, return_logits=True, device="cpu")
    steps = []
    for name in ("backbone_step", "backbone_step_fused"):
        fn = getattr(tgen, name)
        monkeypatch.setattr(tgen, name, lambda *a, fn=fn, **k: steps.append(1) or fn(*a, **k))
    got = tgen.generate(tp["mamba"], tmodel.cfg, **common)
    want_n = NEW if stop is None else stop
    assert got.num_generated == int(ref.num_generated) == want_n
    np.testing.assert_array_equal(nn(got.sequences), np.asarray(ref.sequences))
    assert len(got.logits) == want_n
    assert len(steps) == min(want_n, NEW - 1), len(steps)
    # a per-token callback reads every token: it sees exactly the kept tokens
    seen = []
    each = tgen.generate(tp["mamba"], tmodel.cfg, token_callback=seen.append, **common)
    assert len(seen) == want_n and each.num_generated == want_n
    assert torch.equal(each.sequences, got.sequences)
    for a, b in zip(each.logits, got.logits):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# R1: the JAX package puts its image placeholders (id 0) into the penalty set
# ---------------------------------------------------------------------------


def test_repetition_penalty_leaves_the_image_span_out(pair):
    """Token 0's head row is made 1.05 x the row of the first greedy token,
    so 0 is the greedy choice at step 0. Under a repetition penalty the JAX
    package penalises 0 (its image span is filled with id 0) and picks
    another token; the port does not. The two streams are equal without a
    penalty, and the port with the JAX package's penalty set (every prompt
    position) gives the JAX stream: the image span is the only difference."""
    jmodel, tmodel, jp, tp = pair
    ids = prompts(12, 1, 5)
    jf, tf = features(pair, 13, 1)
    L = ids.shape[1] + N_IMG + 8
    first = t_generate(pair, ids, tf, L, return_logits=True)
    top = int(torch.argmax(first.logits[0][0]))
    assert top != 0 and float(first.logits[0][0, top]) > 0
    jtable = jp["mamba"]["embedding"]
    jtable = jtable.at[0].set(1.05 * jtable[top])
    jp2 = {**jp, "mamba": {**jp["mamba"], "embedding": jtable}}
    tp2 = {**tp, "mamba": {**tp["mamba"], "embedding": tt(jtable)}}
    pair2 = (jmodel, tmodel, jp2, tp2)
    for penalty in (1.0, 10.0):
        sample = SampleParams(top_k=1, repetition_penalty=penalty)
        ref = j_generate(pair2, ids, jf, L, sample=JSampleParams(top_k=1, repetition_penalty=penalty))
        got = t_generate(pair2, ids, tf, L, sample=sample, return_logits=True)
        start = ids.shape[1] + N_IMG
        if penalty == 1.0:
            assert int(got.sequences[0, start]) == 0
            assert_streams_equal(got.sequences, ref.sequences, got.logits, "no penalty")
            continue
        # the port picks 0 at step 0; the JAX package, which penalises it, does not
        assert int(got.sequences[0, start]) == 0 and int(ref.sequences[0, start]) != 0
        splice = nn(got.sequences[:, :start])
        emb = embed_text(tp2["mamba"], tt(ids), torch.float32)
        emb = torch.cat([emb[:, :2], tf, emb[:, 2:]], dim=1)
        as_jax = tgen.generate(tp2["mamba"], tmodel.cfg, input_ids=tt(splice),
                               input_embeddings=emb, task="mmu", max_length=L, sample=sample,
                               eos_token_id=EOS, cache_dtype=None, return_logits=True,
                               device="cpu")
        assert_streams_equal(as_jax.sequences, ref.sequences, as_jax.logits,
                             "the port with the JAX penalty set")


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------


def tiny_train_cfg(**kw):
    return TrainConfig(omnimamba_model="OmniMamba-Tiny", image_backbone="dinosiglip-tiny",
                       t2i_task=False, **kw)


def test_build_model_and_checkpoint(tmp_path):
    model, params, uni = build_model(tiny_train_cfg(), device="cpu")
    want = jcfg.MODEL_REGISTRY["OmniMamba-Tiny"]().resized(50287)
    assert model.cfg.vocab_size == want.vocab_size == 50288
    assert model.cfg.d_model == want.d_model and model.cfg.n_layer == want.n_layer
    assert model.vision_cfg == tcfg.VISION_BACKBONES["dinosiglip-tiny"]()
    assert model.sptids == uni.sptids_dict and model.sptids["<|mmu|>"] == 50283
    assert set(params) == {"mamba", "vision", "projector"}
    assert tuple(params["projector"]["fc3"]["kernel"].shape) == (128, 128)
    again = build_model(tiny_train_cfg(), device="cpu")[1]
    assert torch.equal(again["vision"]["dino"]["pos_embed"], params["vision"]["dino"]["pos_embed"])

    # the port's own training checkpoint of the backbone loads into a new build
    class State:
        step = 5
        opt_state = torch.optim.SGD([torch.zeros(1)], lr=0.1)

    State.params = {"mamba": {k: (v + 1 if isinstance(v, torch.Tensor) else v)
                              for k, v in params["mamba"].items()}}
    CheckpointManager(str(tmp_path)).save(5, State)
    _, loaded, _ = build_model(tiny_train_cfg(omnimamba_ckpt=str(tmp_path)), seed=1, device="cpu")
    assert torch.equal(loaded["mamba"]["embedding"], params["mamba"]["embedding"] + 1)
    assert torch.equal(loaded["mamba"]["layers"][1]["mixer"]["D"],
                       params["mamba"]["layers"][1]["mixer"]["D"])
    assert not torch.equal(loaded["vision"]["dino"]["pos_embed"],
                           params["vision"]["dino"]["pos_embed"])  # not in the checkpoint: seed 1

    # a published state dict (.pth) loads through utils/convert: backbone and projector
    from tests.test_factory_load import _full_omnimamba_sd

    sd = _full_omnimamba_sd(jcfg.MODEL_REGISTRY["OmniMamba-Tiny"]().resized(50287),
                            np.random.default_rng(3))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "omni.pth")
    _, from_pth, _ = build_model(tiny_train_cfg(omnimamba_ckpt=str(tmp_path / "omni.pth")),
                                 device="cpu")
    assert torch.equal(from_pth["mamba"]["embedding"],
                       torch.from_numpy(sd["llm_backbone.mamba.backbone.embedding.weight"]))
    assert torch.equal(from_pth["projector"]["fc1"]["kernel"],
                       torch.from_numpy(sd["projector.projector.0.weight"]).T)
    with pytest.raises(FileNotFoundError):
        build_model(tiny_train_cfg(mamba_pretrain=str(tmp_path / "missing.pth")), device="cpu")


# ---------------------------------------------------------------------------
# the two inference command lines, on the tiny config and the CPU
# ---------------------------------------------------------------------------

TINY_YAML = str(Path(__file__).resolve().parent.parent / "config" / "config_tiny.yaml")


def test_inference_mmu_cli(tmp_path, capsys):
    from omnimamba_tpu_torch.scripts import inference_mmu

    img = tmp_path / "img.npy"
    np.save(img, raw_images(20, 1)[0])
    common = ["--image_path", str(img), "--config", TINY_YAML, "--device", "cpu",
              "--max-length", "48", "--dtype", "float32"]
    answers = inference_mmu.main(common + ["--question", "What is it? *** How many?"])
    assert len(answers) == 2 and all(isinstance(a, str) for a in answers)
    assert str(answers) in capsys.readouterr().out
    # greedy speculative decoding answers the same in fp32
    for mode in ("ngram", "shallow:2"):
        assert inference_mmu.main(common + ["--question", "What is it?", "--speculative", mode]) == (
            answers[:1])
    with pytest.raises(ValueError, match="uint8"):
        np.save(img, np.zeros((4, 4), np.float32))
        inference_mmu.main(common + ["--question", "?"])


def test_inference_t2i_cli(tmp_path):
    from omnimamba_tpu_torch.scripts import inference_t2i

    out = tmp_path / "grid.npy"
    grid = inference_t2i.main(["--prompt", "a corgi on a beach", "--config", TINY_YAML,
                               "--device", "cpu", "--out", str(out), "--cfg-scale", "3",
                               "--batch", "2", "--top-k", "4"])
    assert grid.shape == (256, 512, 3) and grid.dtype == np.uint8
    np.testing.assert_array_equal(np.load(out), grid)

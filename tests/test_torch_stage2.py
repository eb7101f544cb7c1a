"""Stage-2 unified training of the PyTorch port against the JAX package, on the
CPU, in fp32, at the tiny geometry (``tests/test_torch_helpers.py``: the tiny
backbone, the 56-px towers, the fused projector, the tiny VQ).

- ``mmu_loss`` and the gradient of every leaf, in both stages (finetune
  trains the backbone and the projector, align the LoRA factors, the
  projector and the t2i embeddings), with checkpointing on and off, on a
  batch that mixes image rows and text-only rows and holds a row with no
  label; the JAX side through the chunked scan and through the interpreted
  Pallas kernels. Loss to rtol 2e-5; each gradient to 1e-4 (chunked) or
  2e-3 (pallas_ad) of its tree's largest value, the tolerances of
  ``tests/test_torch_train.py``.
- the mixed step (t2i and mmu flows) for two optimizer steps, grad
  accumulation, ``Trainer.train`` fed by ``CombinedLoader`` and
  ``Trainer.evaluate`` on an mmu flow;
- the draft distillation: ``make_draft``, one distillation step, and
  ``acceptance_eval``'s streams against the JAX ``speculative_generate``.

LoRA dropout is off wherever the packages are compared (their random streams
differ). The towers and the VQ must get no gradient and no optimizer state.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.data import transforms as jtr
from omnimamba_tpu.models import omnimamba as jomni
from omnimamba_tpu.models.backbone import embed_text as jembed_text
from omnimamba_tpu.models.speculative import speculative_generate as jspeculative
from omnimamba_tpu.train import distill as jdistill
from omnimamba_tpu.train import optimizer as jopt
from omnimamba_tpu.train import trainer as jtrainer
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.data import coco as tcoco
from omnimamba_tpu_torch.data import llava as tllava
from omnimamba_tpu_torch.data import loader as tloader
from omnimamba_tpu_torch.models import omnimamba as tomni
from omnimamba_tpu_torch.models.vit import dinosiglip_features
from omnimamba_tpu_torch.train import distill as tdistill
from omnimamba_tpu_torch.train import optimizer as topt
from omnimamba_tpu_torch.train import trainer as ttrainer
from omnimamba_tpu_torch.utils.bridge import to_jax_tree
from tests.test_torch_helpers import SPTIDS, bridge, fill_lora_b, tiny_mmu_models, tt
from tests.test_torch_train import assert_trees_close, grad_tol, tree_like

N_TEXT = 12  # text ids of an mmu row after the four specials


def models():
    """The tiny bundles with LoRA dropout off in both packages."""
    jm, tm = tiny_mmu_models()

    def no_dropout(m):
        return m._replace(cfg=dataclasses.replace(
            m.cfg, lora=dataclasses.replace(m.cfg.lora, dropout=0.0)))

    return no_dropout(jm), no_dropout(tm)


@pytest.fixture(scope="module")
def jax_tree():
    """JAX parameters of the whole tiny model (backbone, towers, projector,
    VQ), LoRA B filled and LayerScale gammas at 0.5 so both branches count."""
    jm, _ = models()
    jp = jomni.init_omnimamba(jax.random.PRNGKey(0), jm)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(0))
    dino = dict(jp["vision"]["dino"])
    blocks = dict(dino["blocks"])
    for k in ("ls1", "ls2"):
        blocks[k] = {"gamma": jnp.full_like(blocks[k]["gamma"], 0.5)}
    dino["blocks"] = blocks
    return {**jp, "mamba": {**jp["mamba"], "layers": layers},
            "vision": {"dino": dino, "siglip": jp["vision"]["siglip"]}}


def raw_images(rng, B):
    return rng.integers(0, 256, (B, 60, 50, 3), dtype=np.uint8)


def pixel_dict(jm, raw):
    """The towers' inputs through the JAX transform, as numpy arrays (fed to
    both packages)."""
    return {k: np.asarray(v) for k, v in jtr.dinosiglip_transform(jnp.asarray(raw),
                                                                jm.vision_cfg).items()}


def mmu_flow(seed, B, jm, ignore_pattern=None):
    """Rows 0, 2, 4, ... carry an image, the others are text only; the last
    row has no label at all."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 49, (B, N_TEXT))
    ignore = ignore_pattern if ignore_pattern is not None else rng.random((B, N_TEXT)) < 0.4
    labels = np.where(ignore, tomni.IGNORE_INDEX, ids)
    labels[-1] = tomni.IGNORE_INDEX
    return {"pixel_values": pixel_dict(jm, raw_images(rng, B)), "input_ids": ids,
            "labels": labels, "multimodal_mask": np.arange(B) % 2 == 0}


def t2i_flow(seed, B, tm, n_cap=9):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, tm.cfg.vqvae_vocab_size, (B, tm.cfg.num_tokens)),
            "caption_ids": rng.integers(0, tm.cfg.vocab_size, (B, n_cap))}


def train_cfgs(**kw):
    return jcfg.TrainConfig(**kw), tcfg.TrainConfig(**kw)


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def full_grads(tp, loss):
    """Gradients of the trainable leaves, zeros elsewhere, as a tree like
    ``tp``."""
    named = list(topt.named_leaves(tp))
    train = [t for _, t in named if t.requires_grad]
    grads = iter(torch.autograd.grad(loss, train, allow_unused=True))
    out = []
    for _, t in named:
        g = next(grads) if t.requires_grad else None
        out.append(torch.zeros_like(t) if g is None else g)
    return tree_like(tp, out)


# ---------------------------------------------------------------------------
# mmu_loss and its gradients
# ---------------------------------------------------------------------------

MMU_CASES = [
    ("finetune", False, "chunked", 1e-4),
    ("finetune", True, "pallas_ad", 2e-3),
    ("align", True, "chunked", 1e-4),
    ("align", False, "pallas_ad", 2e-3),
]


@pytest.mark.parametrize("stage,remat,scan_impl,tol", MMU_CASES)
def test_mmu_loss_and_every_gradient(jax_tree, stage, remat, scan_impl, tol):
    jm, tm = models()
    jc, tc = train_cfgs(stage=stage)
    flow = mmu_flow(1, 3, jm)
    tmask = jopt.trainable_mask(jax_tree, stage, jc)

    def jloss(p):
        p = jax.tree.map(lambda x, t: x if t else jax.lax.stop_gradient(x), p, tmask)
        return jomni.mmu_loss(p, jm, jnp_tree(flow["pixel_values"]),
                              jnp.asarray(flow["input_ids"]), jnp.asarray(flow["labels"]),
                              jnp.asarray(flow["multimodal_mask"]), dtype=jnp.float32,
                              scan_impl=scan_impl, remat=remat)

    lj, gj = jax.value_and_grad(jloss)(jax_tree)
    tp = bridge(jax_tree, tm)
    tx, _, _ = topt.make_optimizer(tp, tc)
    lt = tomni.mmu_loss(tp, tm, {k: tt(v) for k, v in flow["pixel_values"].items()},
                        tt(flow["input_ids"]), tt(flow["labels"]), tt(flow["multimodal_mask"]),
                        dtype=torch.float32, remat=remat)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-5)
    gt = to_jax_tree(full_grads(tp, lt), tm)
    assert_trees_close(gt, gj, rtol=tol, atol=grad_tol(gj, tol), what="gradient")

    # the towers and the VQ: no gradient, no optimizer state, no autograd graph
    held = {id(p) for group in tx.param_groups for p in group["params"]}
    for path, leaf in topt.named_leaves(tp):
        if path.startswith(("vision", "vq")):
            assert not leaf.requires_grad and id(leaf) not in held, path
    feats = dinosiglip_features(tp["vision"]["dino"], tp["vision"]["siglip"],
                                {k: tt(v) for k, v in flow["pixel_values"].items()},
                                tm.vision_cfg, remat=True)
    assert feats.grad_fn is None and not feats.requires_grad
    moved = gt["projector"]["fc1"]["kernel"]
    assert np.abs(moved).max() > 0  # the projector trains in both stages
    core = np.abs(gt["mamba"]["layers"]["mixer"]["in_proj"]["x"]).max()
    assert (core > 0) == (stage == "finetune")


def test_tower_checkpointing_only_where_a_tower_trains(jax_tree):
    """remat leaves a trained tower's gradients as they are (1e-6); a frozen
    tower is never checkpointed (there is nothing to keep for it)."""
    _, tm = models()
    tp = bridge(jax_tree, tm)
    flow = mmu_flow(2, 2, models()[0])
    px = {k: tt(v) for k, v in flow["pixel_values"].items()}
    leaves = [t.requires_grad_() for _, t in topt.named_leaves(tp["vision"]["dino"])]

    def grads(remat):
        feats = dinosiglip_features(tp["vision"]["dino"], tp["vision"]["siglip"], px,
                                    tm.vision_cfg, remat=remat)
        # the blocks past depth - 2 and the final norm take no part
        return torch.autograd.grad(feats.square().sum(), leaves, allow_unused=True)

    plain, checkpointed = grads(False), grads(True)
    assert sum(g is not None for g in plain) > 10
    for a, b in zip(plain, checkpointed):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the mixed step, accumulation, the loop, evaluate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", ["finetune", "align"])
def test_mixed_step_two_steps_against_jax(jax_tree, stage):
    """Two optimizer steps on {t2i_flow, mmu_flow}: each flow's loss 1e-5,
    the global norm 1e-4, every updated leaf 1e-4 / 1e-5."""
    jm, tm = models()
    jc, tc = train_cfgs(max_steps=2, warmup_steps=0, lr=8e-4, stage=stage)
    jstate, jtx = jtrainer.create_train_state(jax_tree, jc)
    jstep = jtrainer.make_train_step(jm, jtx, jc, dtype=jnp.float32, donate=False,
                                     scan_impl="chunked")
    tp = bridge(jax_tree, tm)
    tstate, ttx = ttrainer.create_train_state(tp, tc)
    tstep = ttrainer.make_train_step(tm, ttx, tc, dtype=torch.float32, device="cpu")
    for i in range(2):
        batch = {"t2i_flow": t2i_flow(10 + i, 3, tm), "mmu_flow": mmu_flow(20 + i, 3, jm)}
        jstate, jmet = jstep(jstate, jnp_tree(batch), jax.random.PRNGKey(i))
        tstate, tmet = tstep(tstate, batch, None)
        assert set(tmet) == set(jmet)
        for k in ("loss", "loss_t2i", "loss_mmu"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
        assert float(tmet["loss_t2i"]) > 0 and float(tmet["loss_mmu"]) > 0
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
        got = to_jax_tree({k: v for k, v in tstate.params.items() if k != "vq"}, tm)
        want = {k: v for k, v in jstate.params.items() if k != "vq"}
        assert_trees_close(got, want, rtol=1e-4, atol=1e-5, what=f"parameter after step {i + 1}")
    assert tstate.step == 2


def test_mixed_grad_accum_matches_large_batch(jax_tree):
    """grad_accum=2 over two micro-batches of both flows is one step over
    their union (both micro-batches hold as many mmu labels, so the mean of
    their losses is the loss of the union); the mmu pixels arrive raw, so the
    step transforms a stacked (accum, B, H, W, 3) batch too."""
    jm, tm = models()
    pattern = np.random.default_rng(5).random((2, N_TEXT)) < 0.4
    mmu = mmu_flow(6, 4, jm, ignore_pattern=np.concatenate([pattern, pattern]))
    mmu["labels"][1] = mmu["labels"][3] = mmu["input_ids"][1]  # no row without labels
    mmu["pixel_values"] = raw_images(np.random.default_rng(7), 4)
    big = {"t2i_flow": t2i_flow(7, 4, tm), "mmu_flow": mmu}

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return node.reshape(2, 2, *node.shape[1:])

    results = {}
    for accum, batch in ((1, big), (2, stack(big))):
        tc = tcfg.TrainConfig(max_steps=5, warmup_steps=0, lr=1e-3, grad_accum=accum)
        state, tx = ttrainer.create_train_state(bridge(jax_tree, tm), tc)
        step = ttrainer.make_train_step(tm, tx, tc, dtype=torch.float32, device="cpu")
        state, metrics = step(state, batch, None)
        results[accum] = (to_jax_tree({k: v for k, v in state.params.items() if k != "vq"}, tm),
                          metrics)
    (p1, m1), (p2, m2) = results[1], results[2]
    for k in ("loss", "loss_t2i", "loss_mmu"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-4)
    assert_trees_close(p2, p1, rtol=1e-4, atol=1e-5, what="parameter")


def test_remat_resolves_per_flow():
    """The t2i flow counts only its own tokens against the ladder
    (``REMAT_LADDER``); the mmu flow takes remat_mmu (None: checkpointed)."""
    def rung(tokens):
        return next((r for r, limit in ttrainer.REMAT_LADDER if tokens < limit), True)

    t2i = 48 * (73 + 256)  # stage 2's t2i flow alone
    assert ttrainer.resolve_remat("proj", t2i) == rung(t2i) is not False
    assert ttrainer.resolve_remat("proj", 8 * (73 + 256)) is False
    assert tcfg.TrainConfig().remat_mmu is None is jcfg.TrainConfig().remat_mmu


class _Tokenizer:
    """A word-level stand-in of the text tokenizer whose ids fit the tiny
    model's 64-row table (both packages' datasets take it)."""

    pad_token_id = SPTIDS["<|pad|>"]
    eos_token = "</s>"

    def __call__(self, text):
        return {"input_ids": [4 + sum(map(ord, w)) % 44 for w in text.split()]}


class _Prompting:
    text_tokenizer = _Tokenizer()
    sptids_dict = SPTIDS


def stage2_loaders(tmp_path, tm):
    """A CombinedLoader over synthetic COCO rows (8, batch 2) and synthetic
    LLaVA rows with .npy images (6, batch 2; every third row text only)."""
    coco = tcoco.make_synthetic_coco_jsonl(str(tmp_path / "coco.jsonl"), n=8,
                                           num_tokens=tm.cfg.num_tokens, vocab=32, seed=1)
    ann = tllava.make_synthetic_llava_json(str(tmp_path / "llava.json"), n=6,
                                           text_only_every=3, image_shape=(48, 64))
    mmu_ds = tllava.FinetuneDataset(ann, str(tmp_path), _Tokenizer(), max_length=N_TEXT,
                                    eot_id=SPTIDS["<|eot|>"], image_size=56, multimodal_only=False)
    collate = tllava.PaddedCollatorForLanguageModeling(N_TEXT, SPTIDS["<|pad|>"], 56)
    return tloader.CombinedLoader({
        "t2i_flow": tloader.DataLoader(tcoco.MSCOCOFeatureDataset(coco, _Prompting()), 2,
                                       tcoco.coco_collate, seed=3, num_threads=2),
        "mmu_flow": tloader.DataLoader(mmu_ds, 2, collate, seed=4, num_threads=2),
    })


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, step, metrics):
        self.rows.append({"step": step, **{k: float(v) for k, v in metrics.items()}})


def as_jax_batch(batch, jm):
    """A loader batch with the raw pixels through the JAX transform."""
    mmu = dict(batch["mmu_flow"])
    mmu["pixel_values"] = pixel_dict(jm, mmu["pixel_values"])
    return {**batch, "mmu_flow": mmu}


def test_trainer_through_combined_loader_against_jax(jax_tree, tmp_path):
    """``Trainer.train(max_steps=3)`` on the port's CombinedLoader (raw uint8
    pixels, transformed by the step on the device) and the JAX Trainer on the
    same batches (transformed by the JAX transform): every step's losses to
    rtol 2e-5 and grad norm to 1e-4, both flows in every step, text-only rows
    among the mmu rows (every third synthetic row has no image)."""
    jm, tm = models()
    kw = dict(max_steps=3, warmup_steps=0, lr=5e-4, logging_steps=1, stage="finetune", seed=5)
    jc, tc = train_cfgs(**kw)
    (tmp_path / "j").mkdir()
    batches = [as_jax_batch(b, jm) for b in stage2_loaders(tmp_path / "j", tm)][:3]
    assert any(not b["mmu_flow"]["multimodal_mask"].all() for b in batches)
    jrows, trows = _Rows(), _Rows()
    own = jax.tree.map(lambda a: jnp.array(a, copy=True), jax_tree)  # the JAX step donates it
    jtrainer.Trainer(jm, own, jc, batches, dtype=jnp.float32, metrics_writer=jrows,
                     log_fn=lambda s: None).train()
    (tmp_path / "t").mkdir()
    trainer = ttrainer.Trainer(tm, bridge(jax_tree, tm), tc, stage2_loaders(tmp_path / "t", tm),
                               dtype=torch.float32, metrics_writer=trows, log_fn=lambda s: None,
                               device="cpu")
    state, _ = trainer.train()
    assert state.step == 3 and [r["step"] for r in trows.rows] == [1, 2, 3]
    for got, want in zip(trows.rows, jrows.rows, strict=True):
        for k in ("loss", "loss_t2i", "loss_mmu"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=f"{k} step {got['step']}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)


def test_evaluate_on_an_mmu_flow_against_jax(jax_tree):
    """``Trainer.evaluate`` on flow-keyed batches (t2i + mmu) and on a bare
    t2i batch: the same per-task means as the JAX Trainer's."""
    jm, tm = models()
    jc, tc = train_cfgs(stage="finetune")
    mixed = [{"t2i_flow": t2i_flow(30, 2, tm), "mmu_flow": mmu_flow(31, 3, jm)},
             {"mmu_flow": mmu_flow(32, 2, jm)}]
    jt = jtrainer.Trainer(jm, jax_tree, jc, [], dtype=jnp.float32, eval_loader=mixed,
                          log_fn=lambda s: None)
    tt_ = ttrainer.Trainer(tm, bridge(jax_tree, tm), tc, [], dtype=torch.float32,
                           eval_loader=mixed, log_fn=lambda s: None, device="cpu")
    want, got = jt.evaluate(), tt_.evaluate()
    assert set(got) == set(want) == {"eval_t2i_loss", "eval_mmu_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=k)
    tt_.eval_loader = [mixed[0]["t2i_flow"]]
    assert set(tt_.evaluate()) == {"eval_t2i_loss", "eval_loss"}


def test_training_cli_on_synthetic_data(tmp_path, capsys):
    """``scripts/train.py`` on the tiny YAML with synthetic data: it builds
    both flows (the mmu rows multimodal), trains 2 steps and writes the
    metrics."""
    from omnimamba_tpu_torch.scripts import train as cli

    state, metrics = cli.main(["--config", "config/config_tiny.yaml", "--synthetic-data",
                               "--max-steps", "2", "--batch-t2i", "2", "--batch-mmu", "2",
                               "--device", "cpu", "--output-dir", str(tmp_path)])
    assert state.step == 2 and np.isfinite(float(metrics["loss"]))
    assert float(metrics["loss_t2i"]) > 0 and float(metrics["loss_mmu"]) > 0
    (run,) = list(tmp_path.iterdir())
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert "synthetic mmu json" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# draft distillation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backbone_pair(jax_tree):
    jm, tm = models()
    return jm, tm, jax_tree["mamba"], bridge({"mamba": jax_tree["mamba"]}, tm)["mamba"]


def test_make_draft_and_one_distill_step_against_jax(backbone_pair):
    """The draft's layers and norm are fp32 copies that train, the rest the
    target's own tensors; one AdamW step on the same streams: loss and top-1
    1e-5, every trained leaf 1e-4 / 1e-5."""
    jm, tm, jmamba, tmamba = backbone_pair
    jdraft, jdcfg = jdistill.make_draft(jmamba, jm.cfg, 1)
    tdraft, tdcfg = tdistill.make_draft(tmamba, tm.cfg, 1)
    assert tdcfg.n_layer == jdcfg.n_layer == 1
    assert tdraft["embedding"].data_ptr() == tmamba["embedding"].data_ptr()
    assert not tdraft["embedding"].requires_grad and tdraft["norm_f"]["weight"].requires_grad
    assert tdraft["layers"][0]["norm"]["weight"].data_ptr() != \
        tmamba["layers"][0]["norm"]["weight"].data_ptr()

    seqs = np.random.default_rng(8).integers(0, 49, (3, 14))
    jtrain, jfrozen = jdistill._split(jdraft)
    jtx = optax.adamw(1e-3, weight_decay=0.0)
    jstep = jdistill.make_distill_step(jfrozen, jdcfg, jtx, prompt_len=4, dtype=jnp.float32,
                                       scan_impl="chunked")
    jtrain, _, jm_ = jstep(jtrain, jtx.init(jtrain), jnp.asarray(seqs))
    ttrain, tfrozen = tdistill._split(tdraft)
    ttx = torch.optim.AdamW(tdistill._leaves(ttrain), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)
    tstep = tdistill.make_distill_step(tfrozen, tdcfg, ttx, prompt_len=4, dtype=torch.float32)
    ttrain, _, tm_ = tstep(ttrain, ttx, tt(seqs))
    for k in ("loss", "top1"):
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5, err_msg=k)
    model = tm._replace(cfg=tdcfg)
    got = to_jax_tree({"mamba": {"layers": ttrain["layers"], "norm_f": ttrain["norm_f"]}}, model)
    assert_trees_close(got["mamba"], jtrain, rtol=1e-4, atol=1e-5, what="draft")


def test_acceptance_eval_streams_equal_jax_speculative(backbone_pair):
    """``acceptance_eval`` of a 1-layer draft on two prompts: each stream, and
    the drafted and accepted counts, are those of the JAX
    ``speculative_generate`` with the JAX draft; in fp32 every stream is the
    plain greedy one."""
    jm, tm, jmamba, tmamba = backbone_pair
    jdraft, jdcfg = jdistill.make_draft(jmamba, jm.cfg, 1)
    tdraft, tdcfg = tdistill.make_draft(tmamba, tm.cfg, 1)
    tdraft = tdistill.as_draft(*tdistill._split(tdraft), torch.float32)
    prompts = np.random.default_rng(9).integers(4, 49, (2, 5))
    ev = tdistill.acceptance_eval(tmamba, tm.cfg, tdraft, tdcfg, prompts=prompts, gen_len=10,
                                  k_draft=3, dtype=torch.float32, device="cpu")
    assert ev["stream_identical"] and ev["drafted"] > 0
    drafted = accepted = 0
    for i, stream in enumerate(ev["streams"]):
        ids = jnp.asarray(prompts[i:i + 1])
        out = jspeculative(jmamba, jm.cfg, input_ids=ids,
                           input_embeddings=jembed_text(jmamba, ids, jnp.float32), task="mmu",
                           max_length=15, draft_params=jdraft, draft_cfg=jdcfg, k_draft=3,
                           scan_impl="chunked")
        n = 5 + int(out.num_generated)
        np.testing.assert_array_equal(stream.numpy(), np.asarray(out.sequences)[0, :n])
        drafted += int(out.drafted)
        accepted += int(out.accepted)
    assert (ev["drafted"], ev["accepted"]) == (drafted, accepted)


def test_distill_draft_reduces_ce(backbone_pair):
    """The port's whole recipe on the CPU: the draft's cross entropy against
    the target's streams falls, and the draft decodes the target's stream."""
    _, tm, _, tmamba = backbone_pair
    logs = []
    draft, dcfg, metrics = tdistill.distill_draft(
        tmamba, tm.cfg, m_layers=1, steps=20, batch=4, prompt_len=4, gen_len=8, pool_batches=2,
        lr=3e-3, generator=torch.Generator().manual_seed(1), dtype=torch.float32, log_every=19,
        log=logs.append, device="cpu")
    first = float(logs[1].split("CE ")[1].split()[0])
    assert metrics["loss"] < first, (first, metrics)
    ev = tdistill.acceptance_eval(tmamba, tm.cfg, draft, dcfg, n_prompts=2, prompt_len=4,
                                  gen_len=8, k_draft=3, dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(2), device="cpu")
    assert ev["stream_identical"] and ev["drafted"] > 0

"""Stage-1 text-to-image training of the PyTorch port against the JAX package,
on the CPU, in fp32, at the tiny geometry of ``tests/test_torch_helpers.py``.

Parameters come from the JAX ``init_omnimamba`` and go through the port's
bridge; batches come from a numpy seed; gradients and updated parameters go
back through ``to_jax_tree`` and are compared leaf by leaf under the JAX
names. LoRA dropout is off wherever the two packages are compared (their
random streams differ); the port's dropout is tested on its own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.models import omnimamba as jomni
from omnimamba_tpu.train import optimizer as jopt
from omnimamba_tpu.train import trainer as jtrainer
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.models import backbone as tbackbone
from omnimamba_tpu_torch.models import mamba2 as tmamba2
from omnimamba_tpu_torch.models import omnimamba as tomni
from omnimamba_tpu_torch.train import optimizer as topt
from omnimamba_tpu_torch.train import trainer as ttrainer
from omnimamba_tpu_torch.utils.bridge import to_jax_tree
from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_helpers import bridge, fill_lora_b, tiny_models, to_numpy, tt

YAMLS = ("config/config_stage1_t2i.yaml", "config/config_stage1_mmu.yaml",
         "config/config_stage2.yaml")


def models(dropout=0.0):
    jm, tm = tiny_models()
    jm = jm._replace(cfg=dataclasses.replace(
        jm.cfg, lora=dataclasses.replace(jm.cfg.lora, dropout=dropout)))
    tm = tm._replace(cfg=dataclasses.replace(
        tm.cfg, lora=dataclasses.replace(tm.cfg.lora, dropout=dropout)))
    return jm, tm


def jax_params(jm, seed=0):
    """The backbone's parameters with the LoRA B factors moved off zero."""
    jp = jomni.init_omnimamba(jax.random.PRNGKey(seed), jm, with_vision=False, with_vq=False)
    layers = dict(jp["mamba"]["layers"])
    layers["mixer"] = fill_lora_b(layers["mixer"], np.random.default_rng(seed))
    return {"mamba": {**jp["mamba"], "layers": layers}}


def t2i_batch(seed, B, tm, n_cap=9):
    rng = np.random.default_rng(seed)
    return {"t2i_flow": {
        "inputs": rng.integers(0, tm.cfg.vqvae_vocab_size, (B, tm.cfg.num_tokens)),
        "caption_ids": rng.integers(0, tm.cfg.vocab_size, (B, n_cap)),
    }}


def tree_like(params, values):
    """``values`` (one per leaf, in ``named_leaves`` order) in the shape of ``params``."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(params)


def port_grads(loss, params):
    leaves = [t for _, t in topt.named_leaves(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_like(params, [torch.zeros_like(p) if g is None else g
                              for p, g in zip(leaves, grads)])


def require_grad(params):
    for _, t in topt.named_leaves(params):
        t.requires_grad_()
    return params


def assert_trees_close(got, want, rtol, atol, what):
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want_flat = jax.tree_util.tree_flatten_with_path(to_numpy(want))[0]
    assert [k for k, _ in got_flat] == [k for k, _ in want_flat]
    for (path, a), (_, b) in zip(got_flat, want_flat):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=atol, err_msg=f"{what} {jax.tree_util.keystr(path)}")


def grad_tol(tree, rel):
    """atol for a gradient tree: ``rel`` of its largest value."""
    return rel * max(float(np.abs(np.asarray(x)).max()) for x in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# losses and their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_impl,tol", [("chunked", 1e-4), ("pallas_ad", 2e-3)])
def test_t2i_loss_and_every_gradient(scan_impl, tol):
    """Loss to 2e-5 and the gradient of every leaf to ``tol`` of the largest
    gradient: 1e-4 against the chunked scan's autodiff, 2e-3 (the interpreted
    Pallas backward's own bound) with the JAX side on ``pallas_ad``."""
    jm, tm = models()
    jp = jax_params(jm)
    tp = require_grad(bridge(jp, tm))
    flow = t2i_batch(1, 3, tm)["t2i_flow"]

    def jloss(p):
        return jomni.t2i_loss(p, jm, jnp.asarray(flow["inputs"]), jnp.asarray(flow["caption_ids"]),
                              dtype=jnp.float32, scan_impl=scan_impl)

    lj, gj = jax.value_and_grad(jloss)(jp)
    lt = tomni.t2i_loss(tp, tm, tt(flow["inputs"]), tt(flow["caption_ids"]), dtype=torch.float32)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-5)
    gt = to_jax_tree(port_grads(lt, tp), tm)
    assert_trees_close(gt, gj, rtol=tol, atol=grad_tol(gj, tol), what="gradient")
    # the other task's LoRA takes no part
    assert float(np.abs(gt["mamba"]["layers"]["mixer"]["lora"]["mmu_A"]).max()) == 0.0


def test_lm_loss_and_every_gradient():
    jm, tm = models()
    jp = jax_params(jm, seed=1)
    tp = require_grad(bridge(jp, tm))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, tm.cfg.vocab_size, (2, 21))
    labels = np.where(rng.random((2, 21)) < 0.3, tomni.IGNORE_INDEX, ids)

    lj, gj = jax.value_and_grad(lambda p: jomni.lm_loss(
        p, jm, jnp.asarray(ids), jnp.asarray(labels), dtype=jnp.float32))(jp)
    lt = tomni.lm_loss(tp, tm, tt(ids), tt(labels), dtype=torch.float32)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-5)
    assert_trees_close(to_jax_tree(port_grads(lt, tp), tm), gj, rtol=1e-4,
                       atol=grad_tol(gj, 1e-4), what="gradient")


def test_cross_entropy_ignores_and_survives_no_labels():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5))
    labels[0, :3] = tomni.IGNORE_INDEX
    want = jomni.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(tomni.cross_entropy(tt(logits), tt(labels))), float(want),
                               rtol=1e-6)
    nothing = np.full((2, 5), tomni.IGNORE_INDEX)
    assert float(tomni.cross_entropy(tt(logits), tt(nothing))) == 0.0
    assert tomni.IGNORE_INDEX == jomni.IGNORE_INDEX


@pytest.mark.parametrize("dropout_seed", [None, 7], ids=["no_dropout", "dropout"])
def test_remat_equals_no_remat(dropout_seed):
    """Checkpointing every block changes neither the loss nor any gradient
    (1e-6), with dropout on too: the recompute draws the same masks and leaves
    the generator where an unchecked run leaves it."""
    jm, tm = models(dropout=0.25)
    tp = require_grad(bridge(jax_params(jm), tm))
    flow = t2i_batch(4, 2, tm)["t2i_flow"]

    def run(remat):
        g = None if dropout_seed is None else torch.Generator().manual_seed(dropout_seed)
        loss = tomni.t2i_loss(tp, tm, tt(flow["inputs"]), tt(flow["caption_ids"]),
                              dtype=torch.float32, generator=g, remat=remat)
        grads = to_jax_tree(port_grads(loss, tp), tm)
        return loss.item(), grads, None if g is None else g.get_state()

    l0, g0, s0 = run(False)
    l1, g1, s1 = run(True)
    assert abs(l0 - l1) <= 1e-6
    assert_trees_close(g1, g0, rtol=1e-6, atol=1e-6, what="gradient under remat")
    if dropout_seed is not None:
        assert torch.equal(s0, s1)
        assert not torch.equal(s0, torch.Generator().manual_seed(dropout_seed).get_state())


def test_dropout_keeps_its_share_and_repeats_from_a_seed():
    """``_project_parts`` drops a share ``p`` of the LoRA branch's input and
    scales the rest by 1 / (1 - p); the mask is a function of the generator."""
    p, d = 0.25, 32
    mixer = tcfg.Mamba2LayerConfig(d_model=d, d_state=8, headdim=8, expand=1)
    lora = tcfg.LoraConfig(r=d, alpha=d, dropout=p)  # scaling 1
    width = mixer.d_in_proj
    eye_b = torch.zeros((1, d, width))
    eye_b[0, :, :d] = torch.eye(d)
    params = {"in_proj": {"kernel": torch.zeros((d, width))},
              "lora": {"t2i_A": torch.eye(d)[None], "t2i_B": eye_b}}
    x = torch.ones((4, 64, d))

    def z(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return tmamba2._project_parts(params, x, "t2i", mixer, lora, g)["z"]

    assert torch.equal(z(None), x)  # no generator, no dropout
    out = z(0)
    kept = out != 0
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1.0 / (1.0 - p)))
    share = 1.0 - kept.float().mean().item()
    sigma = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(share - p) < 4 * sigma, (share, sigma)
    assert torch.equal(out, z(0)) and not torch.equal(out, z(1))


# ---------------------------------------------------------------------------
# schedule, masks, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 10])
@pytest.mark.parametrize(
    "scheduler", ["cosine_with_min_lr", "linear", "constant_with_warmup", "constant"])
def test_schedules(scheduler, warmup):
    kw = dict(lr=8e-4, warmup_steps=warmup, max_steps=100, scheduler=scheduler, min_lr_rate=0.01)
    js, ts = jopt.make_schedule(jcfg.TrainConfig(**kw)), topt.make_schedule(tcfg.TrainConfig(**kw))
    # the JAX schedule evaluates its cosine in fp32, the port's in Python floats: 1e-5
    for step in (0, 1, warmup, warmup + 1, 55, 99, 100, 140):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"{scheduler} step {step}")


MASK_CASES = {
    "align_t2i_only": dict(stage="align", t2i_task=True, mmu_task=False),
    "align_both": dict(stage="align", t2i_task=True, mmu_task=True),
    "finetune": dict(stage="finetune"),
    "inference": dict(stage="inference"),
}


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_trainable_and_decay_masks_leaf_by_leaf(name):
    """The port's masks, spread over its fused leaves and taken back through
    ``to_jax_tree``, equal the JAX masks under the JAX names."""
    jm, tm = models()
    jp = jax_params(jm)
    tp = bridge(jp, tm)
    kw = MASK_CASES[name]
    jtrain = jopt.trainable_mask(jp, kw["stage"], jcfg.TrainConfig(**kw))
    ttrain = topt.trainable_mask(tp, kw["stage"], tcfg.TrainConfig(**kw))
    for jmask, tmask in ((jtrain, ttrain), (jopt.decay_mask(jp), topt.decay_mask(tp))):
        spread = tree_like(tp, [torch.full_like(t, float(tmask[path]))
                                for path, t in topt.named_leaves(tp)])
        got = jax.tree_util.tree_flatten_with_path(to_jax_tree(spread, tm))[0]
        want = jax.tree_util.tree_flatten_with_path(jmask)[0]
        assert [k for k, _ in got] == [k for k, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert np.all(a == float(b)), jax.tree_util.keystr(path)
    if name == "align_t2i_only":
        assert ttrain["mamba/layers/0/mixer/lora/t2i_B"] and ttrain["mamba/embedding"]
        assert not ttrain["mamba/layers/1/mixer/in_proj/kernel"] and not ttrain["mamba/norm_f/weight"]


def test_frozen_leaves_get_no_gradient_and_no_state():
    _, tm = models()
    tp = bridge(jax_params(models()[0]), tm)
    cfg = tcfg.TrainConfig(stage="align", t2i_task=True, mmu_task=False)
    tx, _, tmask = topt.make_optimizer(tp, cfg)
    held = {id(p) for group in tx.param_groups for p in group["params"]}
    for path, leaf in topt.named_leaves(tp):
        assert leaf.requires_grad == tmask[path] == (id(leaf) in held), path
    assert [g["weight_decay"] for g in tx.param_groups] == [cfg.decay, 0.0]
    assert tx.defaults["betas"] == (0.9, 0.95) and tx.defaults["eps"] == 1e-8


# ---------------------------------------------------------------------------
# the training step (gate 4), grad accumulation
# ---------------------------------------------------------------------------


def _train_cfgs(**kw):
    return jcfg.TrainConfig(**kw), tcfg.TrainConfig(**kw)


def test_gate4_two_steps_against_jax():
    """Stage-1 T2I: two optimizer steps from bridged parameters. Loss 1e-5,
    grad_norm 1e-4, every updated leaf 1e-4 / 1e-5 (Adam divides by the
    gradient's own size, so a leaf's update is as exact as its gradient's
    relative error); the mixer core stays frozen, the image embeddings and
    the LoRA move."""
    jm, tm = models()
    jp = jax_params(jm)
    tp = bridge(jp, tm)
    start = to_jax_tree(tp, tm)
    jc, tc = _train_cfgs(max_steps=2, warmup_steps=0, lr=8e-4, stage="align",
                         t2i_task=True, mmu_task=False)
    jstate, jtx = jtrainer.create_train_state(jp, jc, stage="align")
    jstep = jtrainer.make_train_step(jm, jtx, jc, dtype=jnp.float32, donate=False,
                                     scan_impl="chunked")
    tstate, ttx = ttrainer.create_train_state(tp, tc, stage="align")
    tstep = ttrainer.make_train_step(tm, ttx, tc, dtype=torch.float32, device="cpu")
    for i in range(2):
        batch = t2i_batch(10 + i, 4, tm)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(i))
        tstate, tmet = tstep(tstate, batch, None)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["loss_t2i"]), float(jmet["loss_t2i"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-4)
        assert float(tmet["loss_mmu"]) == 0.0 and set(tmet) == set(jmet)
        assert_trees_close(to_jax_tree(tstate.params, tm), jstate.params, rtol=1e-4, atol=1e-5,
                           what=f"parameter after step {i + 1}")
    assert tstate.step == 2 == int(jstate.step)
    end = to_jax_tree(tstate.params, tm)["mamba"]
    core = end["layers"]["mixer"]["in_proj"]
    assert all(np.array_equal(core[k], start["mamba"]["layers"]["mixer"]["in_proj"][k]) for k in core)
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                         end["img_embeddings"], start["mamba"]["img_embeddings"])
    assert min(jax.tree.leaves(moved)) > 0
    assert np.abs(end["layers"]["mixer"]["lora"]["t2i_B_x"]
                  - start["mamba"]["layers"]["mixer"]["lora"]["t2i_B_x"]).max() > 0


def test_grad_accum_matches_large_batch():
    """grad_accum=2 over two micro-batches is one step over their union (the
    JAX test's tolerances)."""
    _, tm = models()
    big = t2i_batch(0, 4, tm)
    stacked = {"t2i_flow": {k: v.reshape(2, 2, *v.shape[1:]) for k, v in big["t2i_flow"].items()}}
    results = {}
    for accum, batch in ((1, big), (2, stacked)):
        tp = bridge(jax_params(models()[0]), tm)
        cfg = tcfg.TrainConfig(max_steps=5, warmup_steps=0, lr=1e-3, mmu_task=False,
                               grad_accum=accum)
        state, tx = ttrainer.create_train_state(tp, cfg)
        step = ttrainer.make_train_step(tm, tx, cfg, dtype=torch.float32, device="cpu")
        state, metrics = step(state, batch, None)
        results[accum] = (to_jax_tree(state.params, tm), metrics)
    (p1, m1), (p2, m2) = results[1], results[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-4)
    assert_trees_close(p2, p1, rtol=1e-4, atol=1e-5, what="parameter")


def test_accumulate_batches_stacks_drops_and_raises():
    batches = [{"t2i_flow": {"a": np.full((2, 3), i)}} for i in range(5)]
    out = list(ttrainer.accumulate_batches(iter(batches), 2))
    assert len(out) == 2 and out[0]["t2i_flow"]["a"].shape == (2, 2, 3)
    assert (out[0]["t2i_flow"]["a"][1] == 1).all() and (out[1]["t2i_flow"]["a"][0] == 2).all()
    assert len(list(ttrainer.accumulate_batches(iter(batches), 1))) == 5
    with pytest.raises(ValueError, match="grad_accum"):
        list(ttrainer.accumulate_batches(iter(batches[:3]), 4))


# ---------------------------------------------------------------------------
# the loop: metrics, evaluate, checkpoint, resume
# ---------------------------------------------------------------------------


def _trainer(tm, tmp_path, loader, **kw):
    tp = bridge(jax_params(models(dropout=0.1)[0]), tm)
    cfg = tcfg.TrainConfig(max_steps=3, warmup_steps=0, lr=1e-3, logging_steps=1, save_steps=2,
                           stage="align", t2i_task=True, mmu_task=False, seed=5)
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_total_limit=2)
    return ttrainer.Trainer(tm, tp, cfg, loader, dtype=torch.float32, checkpoint_manager=ckpt,
                            device="cpu", **kw)


def test_trainer_checkpoint_restore_gives_the_identical_next_step(tmp_path):
    """train -> checkpoint at step 2 -> step 3; a fresh trainer restores step 2
    (parameters, AdamW moments, dropout generator) and its step 3 gives the
    same bits, with LoRA dropout on."""
    import json

    _, tm = models(dropout=0.1)
    raw = t2i_batch(3, 2, tm)
    loader = [raw] * 4
    eval_loader = [raw["t2i_flow"]]
    logs = []
    writer = ttrainer.MultiWriter(ttrainer.MetricsWriter(str(tmp_path / "m.jsonl")), None)
    first = _trainer(tm, tmp_path, loader, metrics_writer=writer, eval_loader=eval_loader,
                     log_fn=logs.append)
    state, metrics = first.train()
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))
    m = first.evaluate()
    assert np.isfinite(m["eval_loss"]) and m["eval_loss"] == m["eval_t2i_loss"]
    writer.close()
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in rows[:3]] == [1, 2, 3] and "grad_norm" in rows[0]
    assert first.checkpoint_manager.latest_step() == 2 and any("step 1 loss" in str(s) for s in logs)

    second = _trainer(tm, tmp_path, loader, log_fn=lambda s: None)
    assert second.restore() == 2
    state2, _ = second.train(resume_step=2)
    assert state2.step == 3
    for (path, a), (_, b) in zip(topt.named_leaves(state.params), topt.named_leaves(state2.params)):
        assert torch.equal(a, b), path


def test_checkpoint_retention_and_missing(tmp_path):
    _, tm = models()
    tp = bridge(jax_params(models()[0]), tm)
    state, _ = ttrainer.create_train_state(tp, tcfg.TrainConfig(mmu_task=False, stage="align"))
    ckpt = CheckpointManager(str(tmp_path / "ck"), save_total_limit=2)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    assert ckpt.latest_step() is None
    for step in (1, 2, 3):
        ckpt.save(step, state._replace(step=step))
    assert ckpt.all_steps() == [2, 3]
    assert ckpt.restore(state, step=2).step == 2 and ckpt.restore(state).step == 3


def test_emergency_checkpoint_on_failure(tmp_path):
    _, tm = models()

    class Broken:
        def __iter__(self):
            yield t2i_batch(0, 2, tm)
            raise OSError("disk gone")

    logs = []
    tr = _trainer(tm, tmp_path, Broken(), log_fn=logs.append)
    with pytest.raises(OSError, match="disk gone"):
        tr.train()
    assert tr.checkpoint_manager.latest_step() == 1
    assert any("[emergency]" in str(s) for s in logs)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", YAMLS)
def test_train_config_from_yaml_equals_jax(path):
    j = dataclasses.asdict(jcfg.TrainConfig.from_yaml(path))
    t = dataclasses.asdict(tcfg.TrainConfig.from_yaml(path))
    assert j.pop("scan_impl") == "auto"  # no counterpart in the port: a CUDA tensor takes the kernels
    assert t == j


def test_train_config_defaults_equal_jax():
    j = dataclasses.asdict(jcfg.TrainConfig())
    j.pop("scan_impl")
    assert dataclasses.asdict(tcfg.TrainConfig()) == j


def _layers_beside_tp_mesh(tm, **changes):
    """A tp mesh is taken (slice 6b, tests/test_torch_tensor_parallel.py); the
    layers of ROADMAP Q1 item 4 still raise, mesh or not."""
    assert tcfg.TrainConfig(mesh_shape={"dp": 2, "tp": 2}).mesh_shape == {"dp": 2, "tp": 2}
    return tbackbone.check_supported(dataclasses.replace(tm.cfg, **changes))


UNPORTED = {
    "attn_layers_tp_mesh": lambda tm: _layers_beside_tp_mesh(tm, attn_layer_idx=(1,)),
    "gated_mlp_tp_mesh": lambda tm: _layers_beside_tp_mesh(tm, d_intermediate=64),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_what_still_raises_names_its_roadmap_item(name):
    _, tm = models()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNPORTED[name](tm)


def test_remat_rule_resolves_by_tokens():
    (first, first_limit), last_limit = ttrainer.REMAT_LADDER[0], ttrainer.REMAT_LADDER[-1][1]
    assert first is False and ttrainer.resolve_remat("proj", first_limit - 1) is False
    assert ttrainer.resolve_remat("proj", last_limit - 1) is ttrainer.REMAT_LADDER[-1][0]
    assert ttrainer.resolve_remat("proj", last_limit) is True
    assert ttrainer.resolve_remat(True, 1) is True and ttrainer.resolve_remat(False, 10**9) is False
    assert tcfg.TrainConfig().remat == "proj" == jcfg.TrainConfig().remat
    assert tcfg.TrainConfig(mesh_shape={"dp": 1, "tp": 1}).mesh_shape == {"dp": 1, "tp": 1}

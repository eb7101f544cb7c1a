"""Training across ranks (``omnimamba_tpu_torch/parallel/``, the trainer's mesh
path and the training CLI's mesh flags) against the JAX package, on the CPU.

Without processes: the mesh's fill rule against JAX's ``create_mesh``, every
leaf's fsdp dimension against JAX's ``_spec_for`` on the bridged name, the
slice -> whole round trip bit for bit, the decay mask of slices, the rows
``shard_batch`` gives each rank, which meshes the config and the trainer take
(tp: ``tests/test_torch_tensor_parallel.py``).

With processes: two or four gloo ranks (``parallel/launch.run_ranks``; their
programs are in ``tests/torch_parallel_ranks.py``, which imports no JAX), fp32,
at the tiny geometry of ``tests/test_torch_helpers.py``. The parent computes
the reference before it starts the ranks: JAX's single-device
``make_train_step``, without a mesh, on the same bridged parameters and the
whole batch (no test here runs XLA's CPU collectives). One optimizer step is
held to the tolerances of ``tests/test_torch_train.py::test_gate4_two_steps_against_jax``:
loss and per-task losses rtol 1e-5, grad norm rtol 1e-4, every updated leaf
rtol 1e-4 / atol 1e-5. LoRA dropout is off wherever the packages are compared.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.models import omnimamba as jomni
from omnimamba_tpu.ops.quant import quantize_decode_params as jquantize
from omnimamba_tpu.parallel import mesh as jmesh
from omnimamba_tpu.parallel import sharding as jsharding
from omnimamba_tpu.train import optimizer as jopt
from omnimamba_tpu.train import trainer as jtrainer
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.models import omnimamba as tomni
from omnimamba_tpu_torch.ops.quant import quantize_decode_params as tquantize
from omnimamba_tpu_torch.parallel import mesh as tmesh
from omnimamba_tpu_torch.parallel import sharding as tsharding
from omnimamba_tpu_torch.parallel.launch import run_ranks
from omnimamba_tpu_torch.train import optimizer as topt
from omnimamba_tpu_torch.train import trainer as ttrainer
from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager
from tests import torch_parallel_ranks as ranks
from tests.test_torch_helpers import bridge, to_numpy
from tests.test_torch_stage2 import jax_tree as stage2_jax_tree  # noqa: F401 - a fixture
from tests.test_torch_stage2 import mmu_flow, t2i_flow
from tests.test_torch_stage2 import models as mmu_models
from tests.test_torch_train import assert_trees_close, jax_params, models, t2i_batch

TIMEOUT = 300.0  # seconds for every rank of a test to finish


class FakeMesh:
    """One rank's view of a mesh, the parts ``parallel/`` reads (axis names,
    sizes, this rank's coordinates), with no process group: the groups are
    None, so nothing here may run a collective."""

    def __init__(self, coords=None, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())
        self._coords = dict(coords or {})

    def size(self, dim=None):
        return int(np.prod(self._sizes)) if dim is None else self._sizes[dim]

    def get_local_rank(self, axis):
        return self._coords.get(axis, 0)

    def get_group(self, axis):
        return None


def _no_jax(results):
    assert not any(r["jax_loaded"] for r in results), "a rank imported jax or omnimamba_tpu"


# ---------------------------------------------------------------------------
# the mesh, without processes
# ---------------------------------------------------------------------------

SHAPES = [None, {"dp": 8}, {"fsdp": 2}, {"fsdp": 2, "tp": 2}, {"dp": 2, "tp": 4}, {"sp": 4},
          {"dp": 2, "fsdp": 2, "sp": 2}, {"fsdp": 8}]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_fill_rule_equals_jax_create_mesh(shape):
    """Over 8 devices: the same axes in the same order with the same sizes."""
    want = jmesh.create_mesh(shape, jax.devices()[:8]).shape
    assert list(tmesh.mesh_sizes(shape, 8).items()) == list(want.items())


@pytest.mark.parametrize("shape", [{"dp": 3}, {"fsdp": 3}, {"dp": 2, "fsdp": 2, "tp": 4}], ids=str)
def test_mesh_fill_rule_refuses_what_jax_refuses(shape):
    with pytest.raises(AssertionError):
        jmesh.create_mesh(shape, jax.devices()[:8])
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.mesh_sizes(shape, 8)


# ---------------------------------------------------------------------------
# the leaves, without processes
# ---------------------------------------------------------------------------


def _jax_name(port_path):
    """(JAX path, whether JAX stacks the leaf on a leading layer / block axis)
    of a port leaf: the in_proj, conv and LoRA B columns are the first of
    JAX's slices, which share their rule with the rest."""
    path = re.sub(r"(layers|blocks)/\d+/", r"\1/", port_path)
    stacked = path != port_path
    path = (path.replace("in_proj/kernel", "in_proj/z").replace("conv/weight", "conv/weight_x")
            .replace("conv/bias", "conv/bias_x"))
    path = re.sub(r"lora/(t2i|mmu)_B$", r"lora/\1_B_z", path)
    return path, stacked


def _jax_fsdp_axis(port_path, ndim):
    """The port leaf's dimension that JAX's rule puts on fsdp, or None."""
    path, stacked = _jax_name(port_path)
    spec = jsharding._spec_for(path, ndim + stacked)
    axes = [i for i, ax in enumerate(spec) if ax == "fsdp"]
    return axes[0] - stacked if axes else None


@pytest.fixture(scope="module")
def port_trees():
    """The whole tiny model (backbone, towers, projector, VQ) in the port's
    layout, dense and int8 (``quantize_decode_params`` of both packages)."""
    jm, tm = mmu_models()
    jp = jomni.init_omnimamba(jax.random.PRNGKey(0), jm)
    return {"dense": bridge(jp, tm),
            "int8": {"mamba": bridge({"mamba": jquantize(jp["mamba"])}, tm)["mamba"]},
            "int8_port": {"mamba": tquantize(bridge({"mamba": jp["mamba"]}, tm)["mamba"])}}


@pytest.mark.parametrize("tree", ["dense", "int8", "int8_port"])
@pytest.mark.parametrize("n", [2, 4])
def test_every_leaf_is_cut_where_jax_puts_fsdp(port_trees, tree, n):
    """Each leaf's fsdp dimension: JAX's (``_spec_for`` on the bridged name)
    where JAX has one, else 0; whole where ``n`` does not divide it."""
    params = port_trees[tree]
    dims = tsharding.param_shardings(FakeMesh(fsdp=n), params)
    n_jax = 0
    for path, leaf in topt.named_leaves(params):
        jdim = _jax_fsdp_axis(path, leaf.dim())
        assert tsharding.jax_fsdp_dim(path, leaf.dim()) == jdim, path
        n_jax += jdim is not None
        want = 0 if jdim is None else jdim
        if leaf.dim() == 0 or leaf.shape[want] % n:
            want = None
        assert dims[path] == want, (path, tuple(leaf.shape), dims[path], want)
    # in_proj and out_proj of every layer, the two tables: JAX's own axes
    assert n_jax >= 2 * 2 + 2
    assert any(d == 1 for p, d in dims.items() if "out_proj/kernel" in p)


@pytest.mark.parametrize("n", [2, 4])
def test_slices_gather_back_bit_for_bit(port_trees, n):
    """Every rank's slices, stacked in rank order, assemble the whole leaf bit
    for bit; each slice keeps the leaf's rank and ``requires_grad``."""
    params = port_trees["dense"]
    for _, t in topt.named_leaves(params):
        t.requires_grad_(True)
    per_rank = [dict(topt.named_leaves(tsharding.shard_params(FakeMesh({"fsdp": r}, fsdp=n), params)))
                for r in range(n)]
    cut = 0
    for path, full in topt.named_leaves(params):
        slices = [pr[path] for pr in per_rank]
        spec = tsharding.shard_of(slices[0])
        if spec is None:
            assert all(s is full for s in slices), path
            continue
        cut += 1
        assert [tsharding.shard_of(s).index for s in slices] == list(range(n))
        assert all(s.dim() == full.dim() and s.requires_grad for s in slices), path
        assert tsharding.logical_shape(slices[0]) == tuple(full.shape)
        stacked = torch.stack([s.detach() for s in slices])
        assert torch.equal(tsharding.assemble(stacked, spec), full.detach()), path
        assert torch.equal(tsharding.split_slices(full.detach(), spec), stacked), path
    assert cut > 0


def test_decay_mask_of_slices_equals_the_whole_leaves(port_trees):
    """Weight decay follows the whole leaf's rank (JAX's
    ``test_decay_mask_logical_rank``), and so do the trainable masks."""
    params = port_trees["dense"]
    cut = tsharding.shard_params(FakeMesh({"fsdp": 1}, fsdp=2), params)
    assert topt.decay_mask(cut) == topt.decay_mask(params)
    cfg = tcfg.TrainConfig()
    for stage in ("align", "finetune"):
        assert topt.trainable_mask(cut, stage, cfg) == topt.trainable_mask(params, stage, cfg)
    # a (d,) norm weight cut on dimension 0 is still one-dimensional: no decay
    norm = cut["mamba"]["layers"][0]["norm"]["weight"]
    assert tsharding.shard_of(norm).dim == 0 and norm.dim() == 1
    assert not topt.decay_mask(cut)["mamba/layers/0/norm/weight"]


@pytest.mark.parametrize("stacked", [False, True])
def test_shard_batch_gives_each_rank_its_contiguous_rows(stacked):
    """Rows split over dp x fsdp (rank index dp * fsdp_size + fsdp), axis 1
    for a stacked (grad accumulation) batch; nested leaves too."""
    rng = np.random.default_rng(0)
    lead = (2,) if stacked else ()
    batch = {"t2i_flow": {"inputs": rng.integers(0, 9, lead + (8, 5))},
             "mmu_flow": {"pixel_values": {"dino": rng.random(lead + (8, 3, 3))},
                          "multimodal_mask": rng.random(lead + (8,)) < 0.5}}
    axis = 1 if stacked else 0
    got = []
    for dp in range(2):
        for fsdp in range(2):
            mesh = FakeMesh({"dp": dp, "fsdp": fsdp}, dp=2, fsdp=2, tp=1)
            assert tsharding.batch_sharding(mesh) == (2 * dp + fsdp, 4)
            got.append(tsharding.shard_batch(mesh, batch, stacked=stacked))
    for flat in (("t2i_flow", "inputs"), ("mmu_flow", "pixel_values", "dino"),
                 ("mmu_flow", "multimodal_mask")):
        parts = []
        for g in got:
            for k in flat:
                g = g[k]
            parts.append(g)
        want = batch
        for k in flat:
            want = want[k]
        assert all(p.shape[axis] == 2 for p in parts)
        np.testing.assert_array_equal(np.concatenate(parts, axis=axis), want)
    assert tsharding.shard_batch(None, batch) is batch
    bad = {"t2i_flow": {"inputs": np.zeros(lead + (6, 5))}}
    with pytest.raises(ValueError, match="t2i_flow/inputs"):
        tsharding.shard_batch(FakeMesh(dp=4, fsdp=1), bad, stacked=stacked)


def test_loaders_give_each_rank_its_rows_of_the_global_batch(tmp_path):
    """``DataLoader(shard=...)`` and ``NativeCocoLoader(shard=...)``: every rank
    draws the same global batches and collates only its own rows, which
    concatenated in rank order are the global batch, the rows
    ``shard_batch`` gives each rank."""
    from omnimamba_tpu_torch.data.coco import make_synthetic_coco_jsonl
    from omnimamba_tpu_torch.data.loader import DataLoader
    from omnimamba_tpu_torch.data.native import NativeCocoDataset, NativeCocoLoader
    from tests.test_torch_stage2 import _Prompting

    seen = []

    def collate(items):
        seen.extend(items)
        return {"x": np.stack(items)}

    data = [np.full(3, i) for i in range(40)]
    whole = list(DataLoader(data, 8, collate, seed=3, num_threads=0))
    seen.clear()
    parts = [list(DataLoader(data, 8, collate, seed=3, num_threads=0, shard=(r, 4)))
             for r in range(4)]
    assert len(seen) == 40  # each item collated once, by one rank
    for i, batch in enumerate(whole):
        got = [p[i] for p in parts]
        for r, g in enumerate(got):
            mesh = FakeMesh({"dp": r // 2, "fsdp": r % 2}, dp=2, fsdp=2)
            np.testing.assert_array_equal(g["x"], tsharding.shard_batch(mesh, batch)["x"])
    with pytest.raises(ValueError, match="split"):
        list(DataLoader(data, 6, collate, num_threads=0, shard=(0, 4)))

    path = make_synthetic_coco_jsonl(str(tmp_path / "coco.jsonl"), n=32, num_tokens=16)
    ds = NativeCocoDataset(path, _Prompting(), num_tokens=16)
    full = list(NativeCocoLoader(ds, 8, seed=1))
    ranked = [list(NativeCocoLoader(ds, 8, seed=1, shard=(r, 2))) for r in range(2)]
    for i, batch in enumerate(full):
        for key in batch:
            np.testing.assert_array_equal(
                np.concatenate([ranked[r][i][key] for r in range(2)]), batch[key])


def test_tp_meshes_are_taken_and_a_tp_not_dividing_the_heads_raises():
    """The config takes tp beside dp and fsdp (slice 6b); an axis outside
    the three still raises, and so does, in the trainer's check, a tp that
    does not divide the model's heads (the tiny model's 8)."""
    for shape in ({"tp": 2}, {"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 4}, {"dp": 8}, {"fsdp": 4},
                  {"dp": 2, "fsdp": 4, "tp": 1}):
        assert tcfg.TrainConfig(mesh_shape=shape).mesh_shape == shape
    with pytest.raises(ValueError, match="sp"):
        tcfg.TrainConfig(mesh_shape={"sp": 2})
    _, tm = models()
    with pytest.raises(ValueError, match="does not divide"):
        ttrainer.check_train_mesh(FakeMesh(dp=1, fsdp=1, tp=3), tm.cfg.mixer.nheads)


def test_training_cli_mesh_flags_without_ranks(tmp_path):
    """Outside torchrun, ``--tp 2`` and ``--dp 2`` say how to start the run,
    before anything is built; ``--tp`` is an axis of the mesh the flags ask
    for (``mesh_shape``)."""
    from omnimamba_tpu_torch.scripts import train as cli

    base = ["--config", "config/config_tiny.yaml", "--device", "cpu", "--output-dir", str(tmp_path)]
    for flags in (["--tp", "2"], ["--dp", "2"]):
        with pytest.raises(ValueError, match="torchrun"):
            cli.main(base + flags)
    assert not list(tmp_path.iterdir())
    args = cli.parse_args(["--tp", "2", "--fsdp", "2"])
    assert cli.mesh_shape(args, tcfg.TrainConfig()) == {"fsdp": 2, "tp": 2}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_run_ranks_returns_each_ranks_result_by_value():
    out = run_ranks(ranks.tensors_back, 3, timeout=TIMEOUT)
    assert [o["world"] for o in out] == [3, 3, 3]
    for r, o in enumerate(out):
        assert torch.equal(o["sum"], torch.full((4,), 6.0))
        assert o["bf16"].dtype == torch.bfloat16 and float(o["bf16"][0]) == r
        assert o["info"] == (r, 3, r) and o["mesh"] == {"dp": 3, "fsdp": 1, "tp": 1}


def test_init_distributed_one_rank_a_card(monkeypatch):
    """Without torchrun's variables a process is rank 0 of 1 and no group is
    made; a CUDA rank whose card is missing raises instead of sharing one."""
    import torch.distributed as dist

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    info = tmesh.init_distributed("cpu")
    assert tuple(info) == (0, 1, 0, torch.device("cpu")) and not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "3")
    if torch.cuda.device_count() <= 3:
        with pytest.raises(RuntimeError, match="cuda:3"):
            tmesh.init_distributed("cuda")
    with pytest.raises(ValueError, match="device"):
        tmesh.init_distributed("tpu")


def test_run_ranks_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised(.|\\n)*rank 1 gives up"):
        run_ranks(ranks.one_rank_raises, 2, timeout=TIMEOUT)


def test_run_ranks_deadline_ends_a_hang():
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done within 3 s"):
        run_ranks(ranks.sleeps, 2, (60,), timeout=3)
    assert time.monotonic() - t0 < 30  # the sleepers were stopped, not waited for


# ---------------------------------------------------------------------------
# the step across ranks against JAX's single-device step
# ---------------------------------------------------------------------------


def _jax_step(jm, jp, cfg_kwargs, batch):
    """JAX's single-device step on the whole batch: (updated params, metrics,
    the gradients of the step's loss, trainable mask)."""
    # checkpointing changes no number: JAX's step runs without it
    jc = jcfg.TrainConfig(**{k: v for k, v in cfg_kwargs.items() if k != "remat"})
    state, tx = jtrainer.create_train_state(jp, jc, stage=jc.stage)
    step = jtrainer.make_train_step(jm, tx, jc, dtype=jnp.float32, donate=False, scan_impl="chunked")
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))

    def loss(p, b):
        total = 0.0
        if jc.t2i_task and "t2i_flow" in b:
            f = b["t2i_flow"]
            total += jomni.t2i_loss(p, jm, f["inputs"], f["caption_ids"], dtype=jnp.float32,
                                    scan_impl="chunked")
        if jc.mmu_task and "mmu_flow" in b:
            f = b["mmu_flow"]
            total += jomni.mmu_loss(p, jm, f["pixel_values"], f["input_ids"], f["labels"],
                                    f["multimodal_mask"], dtype=jnp.float32, scan_impl="chunked")
        return total

    micro = [batch] if jc.grad_accum == 1 else [jax.tree.map(lambda a, i=i: a[i], batch)
                                                for i in range(jc.grad_accum)]
    grads = [jax.grad(loss)(jp, jax.tree.map(jnp.asarray, m)) for m in micro]
    grads = jax.tree.map(lambda *g: sum(g) / len(g), *grads)
    tmask = jopt.trainable_mask(jp, jc.stage, jc)
    return new.params, {k: float(v) for k, v in metrics.items()}, grads, tmask


def _hold(results, jax_ref, lr):
    """Every rank reports the global batch's metrics (the same bits on each).
    They, rank 0's gradients (every trainable leaf: 1e-4 of the largest JAX
    gradient, the tolerance of tests/test_torch_stage2.py) and rank 0's
    updated parameters equal JAX's step: rtol 1e-4 / atol 1e-5 wherever the
    JAX gradient lies outside that tolerance of zero. Where it lies inside,
    the rounding of the sum decides its sign, and Adam's first step moves the
    element by up to lr either way: those elements are held to 2 lr."""
    jparams, jmetrics, jgrads, tmask = jax_ref
    _no_jax(results)
    first = results[0]["metrics"][0]
    for r in results[1:]:
        assert r["metrics"][0] == first
    for k in ("loss", "loss_t2i", "loss_mmu"):
        np.testing.assert_allclose(first[k], jmetrics[k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(first["grad_norm"], jmetrics["grad_norm"], rtol=1e-4)
    keep = [k for k in jparams if k != "vq"]  # the VQ model does not train
    jgrads, tmask = {k: jgrads[k] for k in keep}, {k: tmask[k] for k in keep}
    g_flat = jax.tree_util.tree_flatten_with_path(to_numpy(jgrads))[0]
    tol = 1e-4 * max(float(np.abs(g).max()) for _, g in g_flat)
    got_g = jax.tree.leaves(results[0]["grads"])
    got_p = jax.tree.leaves(results[0]["params"])
    want_p = jax.tree.leaves(to_numpy({k: jparams[k] for k in keep}))
    trains = jax.tree.leaves(tmask)
    assert len(got_g) == len(g_flat) == len(got_p) == len(want_p) == len(trains)
    decided_total = 0
    for (path, gj), gt, pt, pj, t in zip(g_flat, got_g, got_p, want_p, trains):
        name = jax.tree_util.keystr(path)
        if not t:
            np.testing.assert_array_equal(pt, pj, err_msg=f"frozen {name}")
            continue
        np.testing.assert_allclose(gt, gj, rtol=0, atol=tol, err_msg=f"gradient {name}")
        decided = np.abs(gj) > tol
        decided_total += int(decided.sum())
        np.testing.assert_allclose(pt[decided], pj[decided], rtol=1e-4, atol=1e-5,
                                   err_msg=f"parameter {name}")
        assert np.all(np.abs(pt - pj)[~decided] <= 2 * lr + 1e-7), f"parameter {name}"
    assert decided_total > 0


T2I_CFG = dict(max_steps=4, warmup_steps=0, lr=1e-3, stage="finetune", t2i_task=True,
               mmu_task=False)


@pytest.mark.parametrize("mesh_shape", [{"dp": 2}, {"fsdp": 2}, {"dp": 2, "fsdp": 2}], ids=str)
def test_t2i_step_across_ranks_equals_jax(mesh_shape):
    """Stage 1 (finetune: every backbone leaf trains) on a global batch of 4
    rows: dp sums the gradients, fsdp cuts every leaf, both at once."""
    jm, tm = models()
    jp = jax_params(jm)
    batch = t2i_batch(3, 4, tm)
    ref = _jax_step(jm, jp, T2I_CFG, batch)
    world = int(np.prod(list(mesh_shape.values())))
    results = run_ranks(ranks.train_steps, world,
                        (tm, to_numpy(jp), T2I_CFG, mesh_shape, [batch]), timeout=TIMEOUT)
    _hold(results, ref, T2I_CFG["lr"])
    calls = results[0]["collectives"]
    if "fsdp" in mesh_shape:
        assert results[0]["slices"] > 0 and calls["all_gather"]["calls"] > 0
        assert calls["reduce_scatter"]["calls"] > 0
    else:
        assert results[0]["slices"] == 0 and calls["reduce_scatter"]["calls"] == 0


@pytest.mark.parametrize("remat", [True, "proj_ssd", "dots"])
def test_fsdp_step_under_checkpointing_equals_jax(remat):
    """Under fsdp=2 a checkpointed block gathers its slices again in its
    second forward (``torch.utils.checkpoint``, and a policy's ``BlockTape``
    that keeps some intermediates): the step still equals JAX's, and the
    collectives moved exactly the bytes of every block gathered twice, every
    other slice once, every trainable slice's gradient reduce-scattered once."""
    jm, tm = models()
    jp = jax_params(jm, seed=5)
    cfg = dict(T2I_CFG, remat=remat)
    batch = t2i_batch(8, 4, tm)
    ref = _jax_step(jm, jp, cfg, batch)
    results = run_ranks(ranks.train_steps, 2, (tm, to_numpy(jp), cfg, {"fsdp": 2}, [batch]),
                        timeout=TIMEOUT)
    _hold(results, ref, cfg["lr"])
    for r in results:
        moved = {k: r["collectives"][k]["bytes"] for k in ("all_gather", "reduce_scatter")}
        assert moved == r["checkpointed_step_bytes"]


@pytest.mark.parametrize("mesh_shape", [{"dp": 2}, {"fsdp": 2}], ids=str)
def test_mixed_step_with_unequal_label_counts_equals_jax(stage2_jax_tree, mesh_shape):  # noqa: F811
    """Stage 2's mixed step (t2i + mmu with both towers) where the two ranks'
    mmu rows carry 11 and 2 labels: each rank divides its sum by the global
    count, which the mean of the ranks' means would not give."""
    jm, tm = mmu_models()
    ignore = np.ones((4, 12), bool)
    ignore[0, :9] = ignore[1, 3:5] = ignore[2, :2] = False  # rows 0-1: 11 labels, rows 2-3: 2
    mmu = mmu_flow(5, 4, jm, ignore_pattern=ignore)
    mmu["labels"][-1] = np.where(ignore[-1], tomni.IGNORE_INDEX, mmu["input_ids"][-1])
    batch = {"t2i_flow": t2i_flow(6, 2, tm), "mmu_flow": mmu}
    cfg = dict(max_steps=4, warmup_steps=0, lr=1e-3, stage="finetune")
    ref = _jax_step(jm, stage2_jax_tree, cfg, batch)
    counts = (mmu["labels"] != tomni.IGNORE_INDEX).sum(axis=1)
    assert counts[:2].sum() != counts[2:].sum()  # the ranks' label counts differ
    results = run_ranks(ranks.train_steps, 2,
                        (tm, to_numpy(stage2_jax_tree), cfg, mesh_shape, [batch]), timeout=TIMEOUT)
    _hold(results, ref, cfg["lr"])


@pytest.mark.parametrize("mesh_shape", [{"dp": 2}, {"fsdp": 2}], ids=str)
def test_evaluate_across_ranks_equals_one_card(stage2_jax_tree, mesh_shape):  # noqa: F811
    """``Trainer.evaluate`` with each rank holding its rows of a mixed batch
    whose ranks hold unequal label counts gives one card's losses of the
    whole batch (rtol 1e-6: the same sums in another order)."""
    jm, tm = mmu_models()
    ignore = np.ones((4, 12), bool)
    ignore[0, :9] = ignore[2, :2] = False
    batch = {"t2i_flow": t2i_flow(7, 2, tm), "mmu_flow": mmu_flow(8, 4, jm, ignore_pattern=ignore)}
    one = ttrainer.Trainer(tm, bridge(stage2_jax_tree, tm), tcfg.TrainConfig(), [],
                           dtype=torch.float32, device="cpu", eval_loader=[batch],
                           log_fn=lambda *a: None).evaluate()
    results = run_ranks(ranks.evaluate_rows, 2, (tm, to_numpy(stage2_jax_tree), mesh_shape, batch),
                        timeout=TIMEOUT)
    _no_jax(results)
    for r in results:
        assert set(r["metrics"]) == set(one) == {"eval_t2i_loss", "eval_mmu_loss"}
        for k, v in one.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-6, err_msg=k)


def test_grad_accum_under_dp2_equals_jax():
    """grad_accum=2: the micro-batch axis stays whole, each micro-batch's
    rows split over the ranks; one update, as JAX's scanned accumulation."""
    jm, tm = models()
    jp = jax_params(jm, seed=2)
    big = t2i_batch(4, 8, tm)
    stacked = {"t2i_flow": {k: v.reshape(2, 4, *v.shape[1:]) for k, v in big["t2i_flow"].items()}}
    cfg = dict(T2I_CFG, grad_accum=2)
    ref = _jax_step(jm, jp, cfg, stacked)
    results = run_ranks(ranks.train_steps, 2, (tm, to_numpy(jp), cfg, {"dp": 2}, [stacked]),
                        timeout=TIMEOUT)
    _hold(results, ref, cfg["lr"])


def test_align_stage_frozen_leaves_under_fsdp2():
    """Stage 1 align: the frozen core is gathered but never reduce-scattered
    and stays bit for bit; the trainable leaves equal JAX's step."""
    jm, tm = models()
    jp = jax_params(jm, seed=3)
    cfg = dict(T2I_CFG, stage="align")
    batch = t2i_batch(5, 4, tm)
    ref = _jax_step(jm, jp, cfg, batch)
    results = run_ranks(ranks.train_steps, 2, (tm, to_numpy(jp), cfg, {"fsdp": 2}, [batch]),
                        timeout=TIMEOUT)
    _hold(results, ref, cfg["lr"])
    start = to_numpy(jp)["mamba"]["layers"]["mixer"]
    end = results[0]["params"]["mamba"]["layers"]["mixer"]
    for k in ("in_proj", "out_proj", "conv"):
        for leaf, want in zip(jax.tree.leaves(end[k]), jax.tree.leaves(start[k])):
            np.testing.assert_array_equal(leaf, want)
    tcut = dict(topt.named_leaves(tsharding.shard_params(
        FakeMesh(fsdp=2), bridge(jp, tm))))
    tmask = topt.trainable_mask(tcut, "align", tcfg.TrainConfig(**cfg))
    trainable_cut = sum(1 for p, t in tcut.items() if tmask[p] and tsharding.shard_of(t))
    calls = results[0]["collectives"]
    assert 0 < calls["reduce_scatter"]["calls"] <= trainable_cut < calls["all_gather"]["calls"]


def test_checkpoint_saved_at_fsdp2_restores_on_one_rank_bit_for_bit(tmp_path):
    """Two fsdp ranks step and save; one process without a group restores the
    file into a one-card state: every parameter, every AdamW moment and rank
    0's generator bit for bit, and the file is the one-card format."""
    jm, tm = models()
    jp = jax_params(jm, seed=4)
    results = run_ranks(ranks.checkpoint_save, 2,
                        (tm, to_numpy(jp), T2I_CFG, {"fsdp": 2}, t2i_batch(6, 4, tm),
                         str(tmp_path)), timeout=TIMEOUT)
    _no_jax(results)
    state, _ = ttrainer.create_train_state(bridge(jp, tm), tcfg.TrainConfig(**T2I_CFG))
    gen = torch.Generator()
    restored = CheckpointManager(str(tmp_path)).restore(state, None, gen)
    assert restored.step == 1
    saved = results[0]["params"]
    for path, leaf in topt.named_leaves(restored.params):
        assert np.array_equal(leaf.detach().numpy(), saved[path]), path
    moments = restored.opt_state.state_dict()["state"]
    assert set(moments) == set(results[0]["moments"])
    for i, entry in results[0]["moments"].items():
        for k, v in entry.items():
            got = moments[i][k]
            assert np.array_equal(got.numpy() if torch.is_tensor(got) else got, v), (i, k)
    assert np.array_equal(gen.get_state().numpy(), results[0]["generator"])
    payload = torch.load(tmp_path / "step_1.pt", weights_only=True)
    assert [g.numpy().tolist() for g in payload["generators"]] == \
        [r["generator"].tolist() for r in results]


def test_dropout_masks_differ_between_ranks():
    """Each rank's dropout generator starts from (seed, rank): rank 0 draws
    what one card draws, rank 1 another stream."""
    jm, tm = models(dropout=0.1)
    jp = jax_params(jm)
    cfg = dict(T2I_CFG, seed=7)
    results = run_ranks(ranks.dropout_draws, 2, (tm, to_numpy(jp), cfg, {"dp": 2}), timeout=TIMEOUT)
    _no_jax(results)
    one_card = torch.rand(16, generator=torch.Generator().manual_seed(7)).numpy()
    np.testing.assert_array_equal(results[0]["draws"], one_card)
    assert not np.allclose(results[0]["draws"], results[1]["draws"])


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--fsdp", "2"]], ids=" ".join)
def test_training_cli_under_two_ranks(tmp_path, flags):
    """``scripts/train.py`` as two ranks of one group: the tiny YAML, both
    flows, synthetic data, 2 steps; the same global metrics on both ranks and
    one run directory whose metrics rank 0 alone wrote."""
    import json

    results = run_ranks(ranks.training_cli, 2, (str(tmp_path), flags), timeout=TIMEOUT)
    _no_jax(results)
    assert [r["step"] for r in results] == [2, 2]
    assert results[0]["metrics"] == results[1]["metrics"]
    assert np.isfinite(results[0]["metrics"]["loss"]) and results[0]["metrics"]["loss_mmu"] > 0
    assert (results[0]["slices"] > 0) == ("--fsdp" in flags)
    (run,) = list(tmp_path.iterdir())
    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[-1]["loss"] == pytest.approx(results[0]["metrics"]["loss"])

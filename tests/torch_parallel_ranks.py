"""Rank programs of ``tests/test_torch_parallel.py`` and
``tests/test_torch_sequence_parallel.py``. Each function runs in a process of
its own, one rank of a gloo group started by
``omnimamba_tpu_torch.parallel.launch.run_ranks``, on the CPU.

This module imports neither ``jax`` nor ``omnimamba_tpu``: a rank imports it
to find its function, and the ranks of the port must run without them. The
parent computes the JAX references and hands numpy arrays in; parameters come
as the JAX tree in numpy and go through the port's bridge here. Every result
says whether the rank had JAX loaded (``jax_loaded``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from omnimamba_tpu_torch.config import TrainConfig
from omnimamba_tpu_torch.parallel import create_mesh, shard_batch, shard_params
from omnimamba_tpu_torch.parallel.sharding import (
    COLLECTIVES, logical_shape, reset_collective_counts, shard_of, tp_of, whole_like, whole_tensor)
from omnimamba_tpu_torch.train import trainer as ttrainer
from omnimamba_tpu_torch.utils.bridge import from_jax_params, to_jax_tree
from omnimamba_tpu_torch.utils.tree import map_named, named_leaves


def _jax_loaded() -> bool:
    return any(m == "jax" or m.startswith(("jax.", "omnimamba_tpu.")) or m == "omnimamba_tpu"
               for m in sys.modules)


def _whole_tree(params):
    """Every slice gathered whole (all ranks call it, in leaf order)."""
    return map_named(lambda _, t: whole_tensor(t).detach().clone(), params)


def _setup(tm, jax_np, cfg_kwargs, mesh_shape):
    mesh = create_mesh(mesh_shape, "cpu")
    params = shard_params(mesh, from_jax_params(jax_np, tm, device="cpu"))
    cfg = TrainConfig(**cfg_kwargs)
    state, tx = ttrainer.create_train_state(params, cfg)
    step = ttrainer.make_train_step(tm, tx, cfg, mesh=mesh, dtype=torch.float32, device="cpu")
    return mesh, cfg, state, step


def train_steps(rank, world, tm, jax_np, cfg_kwargs, mesh_shape, batches):
    """The gradients of the first global batch (``make_grad_fn``), then
    ``len(batches)`` optimizer steps (``make_train_step``) over this rank's
    rows of each; returns the metrics of each step, the collectives' counts
    and (rank 0) the whole gradients and updated parameters under the JAX
    names."""
    mesh = create_mesh(mesh_shape, "cpu")
    params = shard_params(mesh, from_jax_params(jax_np, tm, device="cpu"))
    cfg = TrainConfig(**cfg_kwargs)
    state, tx = ttrainer.create_train_state(params, cfg)
    kw = dict(mesh=mesh, dtype=torch.float32, device="cpu")
    step = ttrainer.make_train_step(tm, tx, cfg, **kw)
    stacked = cfg.grad_accum > 1
    _, _, grads, _ = ttrainer.make_grad_fn(tm, cfg, **kw)(
        state.params, shard_batch(mesh, batches[0], stacked=stacked), None)
    trainable = iter(grads)
    grad_tree = map_named(lambda _, t: whole_like(next(trainable), t)
                          if t.requires_grad else torch.zeros(logical_shape(t)), state.params)
    n_cut = sum(shard_of(t) is not None for _, t in named_leaves(state.params))
    n_tp = sum(tp_of(t) is not None and tp_of(t).dim is not None
               for _, t in named_leaves(state.params))
    reset_collective_counts()
    metrics = []
    for batch in batches:
        state, m = step(state, shard_batch(mesh, batch, stacked=stacked), None)
        metrics.append({k: float(v) for k, v in m.items()})
    calls = {k: dict(v) for k, v in COLLECTIVES.items()}
    params = _whole_tree(state.params)
    # the bytes a checkpointed step must move (chip_smoke.py's _mr_expected_traffic): every
    # block's slices gathered twice, every other slice the t2i flow reads once (all but the
    # mmu positions), every trainable slice's gradient reduce-scattered once
    gather = scatter = 0
    for path, t in named_leaves(state.params):
        if shard_of(t) is not None and path != "mamba/mmu_pos_embed":
            whole = int(np.prod(shard_of(t).full_shape)) * t.element_size()
            gather += whole * (2 if path.startswith("mamba/layers/") else 1)
            scatter += whole if t.requires_grad else 0

    def named(tree):
        return to_jax_tree({k: v for k, v in tree.items() if k != "vq"}, tm) if rank == 0 else None

    return {"rank": rank, "metrics": metrics, "jax_loaded": _jax_loaded(), "slices": n_cut,
            "tp_slices": n_tp, "collectives": calls, "params": named(params), "grads": named(grad_tree),
            "checkpointed_step_bytes": {"all_gather": gather * len(batches),
                                        "reduce_scatter": scatter * len(batches)}}


def checkpoint_save(rank, world, tm, jax_np, cfg_kwargs, mesh_shape, batch, directory):
    """One step, then a checkpoint of it (every rank saves, rank 0 writes);
    rank 0 returns the whole parameters and AdamW moments by leaf path."""
    from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager, _whole_moments

    mesh, cfg, state, step = _setup(tm, jax_np, cfg_kwargs, mesh_shape)
    state, _ = step(state, shard_batch(mesh, batch), None)
    gen = torch.Generator().manual_seed(100 + rank)
    CheckpointManager(directory).save(1, state, gen)
    params = {p: t.numpy().copy() for p, t in named_leaves(_whole_tree(state.params))}
    moments = _whole_moments(state.opt_state)["state"]
    return {"rank": rank, "jax_loaded": _jax_loaded(), "generator": gen.get_state().numpy(),
            "params": params if rank == 0 else None,
            "moments": ({i: {k: (v.numpy().copy() if torch.is_tensor(v) else v)
                             for k, v in e.items()} for i, e in moments.items()}
                        if rank == 0 else None)}


def dropout_draws(rank, world, tm, jax_np, cfg_kwargs, mesh_shape):
    """The first draws of each rank's dropout generator, as the trainer seeds it."""
    mesh = create_mesh(mesh_shape, "cpu")
    params = shard_params(mesh, from_jax_params(jax_np, tm, device="cpu"))
    trainer = ttrainer.Trainer(tm, params, TrainConfig(**cfg_kwargs), [], mesh=mesh,
                               dtype=torch.float32, device="cpu", log_fn=lambda *a: None)
    return {"rank": rank, "jax_loaded": _jax_loaded(),
            "draws": torch.rand(16, generator=trainer.generator).numpy()}


def evaluate_rows(rank, world, tm, jax_np, mesh_shape, batch):
    """``Trainer.evaluate`` over this rank's rows of one global batch."""
    mesh = create_mesh(mesh_shape, "cpu")
    params = shard_params(mesh, from_jax_params(jax_np, tm, device="cpu"))
    trainer = ttrainer.Trainer(tm, params, TrainConfig(), [], mesh=mesh, dtype=torch.float32,
                               device="cpu", eval_loader=[shard_batch(mesh, batch)],
                               log_fn=lambda *a: None)
    return {"rank": rank, "jax_loaded": _jax_loaded(), "metrics": trainer.evaluate()}


def training_cli(rank, world, out_dir, extra):
    """``python -m omnimamba_tpu_torch.scripts.train`` as one rank of the
    group: the tiny YAML, synthetic data, 2 steps."""
    from omnimamba_tpu_torch.scripts import train as cli

    state, metrics = cli.main(["--config", "config/config_tiny.yaml", "--synthetic-data",
                               "--max-steps", "2", "--batch-t2i", "4", "--batch-mmu", "2",
                               "--device", "cpu", "--output-dir", out_dir, *extra])
    return {"rank": rank, "jax_loaded": _jax_loaded(), "step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "slices": sum(shard_of(t) is not None for _, t in named_leaves(state.params)),
            "tp_slices": sum(tp_of(t) is not None for _, t in named_leaves(state.params))}


# ---------------------------------------------------------------------------
# sequence parallel
# ---------------------------------------------------------------------------


def _own(a: np.ndarray, rank: int, world: int, axis: int = 1) -> torch.Tensor:
    """This rank's slice along ``axis`` of a whole array."""
    per = a.shape[axis] // world
    return torch.from_numpy(np.ascontiguousarray(np.take(a, np.arange(rank * per, (rank + 1) * per),
                                                         axis=axis)))


def ssd_sp(rank, world, inputs):
    """``ssd_sequence_parallel`` of this rank's slices, with D and without;
    also ``halo_left`` of x's rows."""
    from omnimamba_tpu_torch.parallel.sequence import halo_left, ssd_sequence_parallel

    mesh = create_mesh({"sp": world}, "cpu")
    x, dt, A, Bm, Cm, D = (inputs[k] for k in ("x", "dt", "A", "B", "C", "D"))
    own = [_own(a, rank, world) for a in (x, dt, Bm, Cm)]
    out = {"rank": rank, "jax_loaded": _jax_loaded()}
    for name, d in (("with_D", torch.from_numpy(D)), ("without_D", None)):
        y, state = ssd_sequence_parallel(mesh, own[0], own[1], torch.from_numpy(A), own[2],
                                         own[3], d)
        out[name] = (y.numpy(), state.numpy())
    flat = own[0].reshape(own[0].shape[0], own[0].shape[1], -1)
    out["halo"] = halo_left(flat, 3, mesh.get_group("sp")).numpy()
    out["counts"] = {k: dict(v) for k, v in COLLECTIVES.items()}
    return out


def backbone_sp(rank, world, tm, jax_backbone_np, emb, add_mmu_pos, tp=1):
    """``backbone_forward_sp`` of this rank's slice of ``emb`` (mmu); with
    ``tp`` > 1 on a (tp, sp) mesh, each mixer on the rank's heads."""
    from omnimamba_tpu_torch.models.backbone import backbone_forward_sp

    mesh = create_mesh({"tp": tp, "sp": world // tp}, "cpu")
    params = from_jax_params({"mamba": jax_backbone_np}, tm, device="cpu")["mamba"]
    params = shard_params(mesh, params)
    sp = mesh.get_local_rank("sp")
    with torch.no_grad():
        h = backbone_forward_sp(params, _own(emb, sp, world // tp), "mmu", tm.cfg, mesh,
                                add_mmu_pos=add_mmu_pos)
    return {"rank": rank, "jax_loaded": _jax_loaded(), "hidden": h.numpy(), "sp": sp,
            "tp": mesh.get_local_rank("tp") if tp > 1 else 0}


# ---------------------------------------------------------------------------
# the launcher itself
# ---------------------------------------------------------------------------


def tensors_back(rank, world):
    """Tensors on the CPU come back by value, after the rank has ended."""
    import torch.distributed as dist

    from omnimamba_tpu_torch.parallel.mesh import init_distributed, local_mesh_1d

    t = torch.full((4,), float(rank + 1))
    dist.all_reduce(t)
    info = init_distributed("cpu")  # keeps the launcher's group
    mesh = local_mesh_1d(device_type="cpu")
    return {"sum": t, "bf16": torch.ones(3, dtype=torch.bfloat16) * rank, "world": world,
            "info": tuple(info[:3]), "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}


def one_rank_raises(rank, world):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()


def sleeps(rank, world, seconds):
    import time

    time.sleep(seconds)


# ---------------------------------------------------------------------------
# tensor parallel over heads: decoding
# ---------------------------------------------------------------------------


def tp_decode(rank, world, cfg, jax_backbone_np, mesh_shape, ids, emb, runs):
    """Decode runs under a tp mesh, each ``(name, kind, kwargs)``: ``kind``
    "generate" or "speculative" (task mmu, on this rank's heads of the
    backbone, which comes in JAX's names; ``int8_weights`` in kwargs
    quantizes the whole tree before it is cut). Returns every run's token
    stream and the tp collectives' counts of each run, and whether the
    whole tree quantized then cut equals the cut tree quantized, leaf by leaf
    (``quant_cut_equal``: out_proj's scales take the maximum over the ranks)."""
    from omnimamba_tpu_torch.config import VQConfig
    from omnimamba_tpu_torch.models.generation import generate
    from omnimamba_tpu_torch.models.omnimamba import OmniMambaModel
    from omnimamba_tpu_torch.models.speculative import speculative_generate
    from omnimamba_tpu_torch.ops.decode_fused import fused_decode_step
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params
    from omnimamba_tpu_torch.ops.sampling import SampleParams

    mesh = create_mesh(mesh_shape, "cpu")
    model = OmniMambaModel(cfg=cfg, vq_cfg=VQConfig(), sptids={})
    whole = from_jax_params({"mamba": jax_backbone_np}, model, device="cpu")["mamba"]
    ids, emb = torch.from_numpy(ids), torch.from_numpy(emb)
    out = {"rank": rank, "jax_loaded": _jax_loaded(), "streams": {}, "collectives": {},
           "tp_steps": {}}
    one_way = dict(named_leaves(shard_params(mesh, quantize_decode_params(whole))))
    other = dict(named_leaves(quantize_decode_params(shard_params(mesh, whole))))
    index = mesh.get_local_rank("tp")

    def same(a, b):  # project_in fc1's scale: whole one way, the rank's columns the other
        n = b.shape[-1]
        return torch.equal(a if a.shape == b.shape else a[..., index * n:(index + 1) * n], b)

    out["quant_cut_equal"] = one_way.keys() == other.keys() and all(
        same(one_way[k], other[k]) for k in one_way)
    for name, kind, kw in runs:
        kw = dict(kw)
        params = whole
        if kw.pop("int8_weights", False):
            params = quantize_decode_params(params)
        params = shard_params(mesh, params)
        reset_collective_counts()
        fused_decode_step.tp_launches = 0
        with torch.no_grad():
            if kind == "speculative":
                seqs = speculative_generate(params, cfg, input_ids=ids, input_embeddings=emb,
                                            task="mmu", device="cpu", **kw).sequences
            else:
                seqs = generate(params, cfg, input_ids=ids, input_embeddings=emb, task="mmu",
                                sample=SampleParams(top_k=1), device="cpu", **kw).sequences
        out["streams"][name] = seqs.numpy()
        out["collectives"][name] = {k: dict(v) for k, v in COLLECTIVES.items()}
        out["tp_steps"][name] = fused_decode_step.tp_launches
    return out

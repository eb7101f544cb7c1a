"""Tensor parallelism over Mamba-2 heads (tp) in the port against the JAX
package, on the CPU.

Without processes: every leaf's tp cut against JAX's ``_spec_for`` on the
bridged name (dense and both int8 trees, tp 2 and 4); the slices of tp=2 and
of fsdp=2 x tp=2 gathered back bit for bit; the partial-sum gated norm's
plain forward and backward over two halves of d_inner against the whole-row
plain versions; K4's plain step run layer by layer on two halves of the
heads, their partials added, against one rank's plain step.

With processes (gloo ranks of ``parallel/launch.run_ranks``, programs in
``tests/torch_parallel_ranks.py``, which import no JAX), each held against
JAX's single-device function computed in the parent: the mixed stage-2 step
and the stage-1 step under checkpointing (loss, every leaf's gradient, every
updated leaf: ``test_torch_parallel._hold``'s tolerances, 1e-4 of the largest
gradient, rtol 1e-4 / atol 1e-5 on the leaves); speculative decoding and the
fp32 greedy streams of both decode paths equal to JAX's; the int8-state
stream agreeing on at least 70% of its tokens (JAX's own rule); the ranks'
streams identical; a tp=2 checkpoint restored on one rank bit for bit; the
training CLI with ``--tp 2``.

Tolerances of the halves without processes (fp32): 1e-6 of the largest
value (the same sums in another order).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.models.backbone import embed_text as jembed_text
from omnimamba_tpu.models.backbone import init_backbone as jinit_backbone
from omnimamba_tpu.models.generation import generate as jgenerate
from omnimamba_tpu.models.speculative import speculative_generate as jspeculative
from omnimamba_tpu.ops.sampling import SampleParams as JSample
from omnimamba_tpu.parallel import sharding as jsharding
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.models.backbone import BackboneCache
from omnimamba_tpu_torch.ops import norms as tnorms
from omnimamba_tpu_torch.ops.decode_fused import (
    fused_decode_finish_plain,
    fused_decode_layer_plain,
    fused_decode_step_plain,
)
from omnimamba_tpu_torch.parallel import sharding as tsharding
from omnimamba_tpu_torch.train import optimizer as topt
from omnimamba_tpu_torch.train import trainer as ttrainer
from omnimamba_tpu_torch.utils.checkpoint import CheckpointManager
from tests import torch_parallel_ranks as ranks
from tests.test_backbone import tiny_config
from tests.test_torch_helpers import bridge, bridge_backbone, to_numpy, torch_config
from tests.test_torch_parallel import TIMEOUT, FakeMesh, _hold, _jax_name, _jax_step, _no_jax
from tests.test_torch_parallel import port_trees  # noqa: F401 - a fixture
from tests.test_torch_stage2 import jax_tree as stage2_jax_tree  # noqa: F401 - a fixture
from tests.test_torch_stage2 import mmu_flow, t2i_flow
from tests.test_torch_stage2 import models as mmu_models
from tests.test_torch_train import jax_params, models, t2i_batch

HALVES_TOL = 1e-6  # of the largest value: fp32, the same sums in another order


def _tp_mesh(tp, index, fsdp=1, fsdp_index=0):
    return FakeMesh({"tp": index, "fsdp": fsdp_index}, dp=1, fsdp=fsdp, tp=tp)


# ---------------------------------------------------------------------------
# the leaves, without processes
# ---------------------------------------------------------------------------


def _jax_tp_axis(port_path, ndim):
    """The port leaf's dimension that JAX's rule puts on tp, or None."""
    path, stacked = _jax_name(port_path)
    spec = jsharding._spec_for(path, ndim + stacked)
    axes = [i for i, ax in enumerate(spec) if ax == "tp"]
    return axes[0] - stacked if axes else None


@pytest.mark.parametrize("tree", ["dense", "int8", "int8_port"])
@pytest.mark.parametrize("n", [2, 4])
def test_every_leaf_is_cut_where_jax_puts_tp(port_trees, tree, n):  # noqa: F811
    """Each leaf's tp dimension is JAX's (``_spec_for`` on the bridged name,
    whose z, x and conv-x parts stand for the fused leaves); the parts JAX
    keeps whole (in_proj's bc and dt, their scales, the conv's bc channels)
    stay whole in the port's cut. One deliberate difference: the LoRA B
    factors, which JAX keeps whole, are cut as in_proj is (K4 reads one
    contiguous factor a rank). The partial leaves (LoRA A, dt_bias, A_log,
    D, fc1's bias) are whole in both."""
    params = port_trees[tree]
    cuts = tsharding.param_cuts(_tp_mesh(n, 1), params)
    for kind in ("bc", "dt"):
        assert "tp" not in jsharding._spec_for(f"layers/mixer/in_proj/{kind}", 3)
    assert "tp" not in jsharding._spec_for("layers/mixer/conv/weight_bc", 3)
    n_cut = n_partial = 0
    for path, leaf in topt.named_leaves(params):
        cut, _ = cuts[path]
        jdim = _jax_tp_axis(path, leaf.dim())
        if re.search(r"lora/(t2i|mmu)_B$", path):
            assert jdim is None and cut.dim == 2, path
            continue
        if cut is None or cut.dim is None:
            assert jdim is None, (path, jdim)
            n_partial += cut is not None
            continue
        n_cut += 1
        assert cut.dim == jdim, (path, cut.dim, jdim)
        whole = [(s, n_) for s, n_, is_cut in cut.segments if not is_cut]
        if "in_proj" in path:  # z | x cut, bc | dt whole, as JAX's rules
            di = leaf.shape[cut.dim] - whole[0][1]
            assert whole == [(di, leaf.shape[cut.dim] - di)] and di % 2 == 0, path
        elif "conv" in path:
            assert len(whole) == 1, path
        else:
            assert not whole, path
    assert n_cut >= 2 * 5 and n_partial >= 2 * 3


@pytest.mark.parametrize("shape", [{"tp": 2}, {"fsdp": 2, "tp": 2}], ids=str)
def test_tp_slices_gather_back_bit_for_bit(port_trees, shape):  # noqa: F811
    """Every rank's slices (tp, then fsdp of the tp slice) assemble the whole
    leaf bit for bit: ``assemble`` over fsdp, then ``tp_assemble`` over tp;
    ``local_part`` of the whole leaf is each rank's slice; ``logical_shape``
    is the whole leaf's."""
    params = port_trees["int8"] if "fsdp" not in shape else port_trees["dense"]
    n_tp, n_f = shape["tp"], shape.get("fsdp", 1)
    per = {(t, f): dict(topt.named_leaves(tsharding.shard_params(_tp_mesh(n_tp, t, n_f, f), params)))
           for t in range(n_tp) for f in range(n_f)}
    cut_leaves = 0
    for path, full in topt.named_leaves(params):
        tp_parts = []
        for t in range(n_tp):
            slices = [per[(t, f)][path] for f in range(n_f)]
            spec = tsharding.shard_of(slices[0])
            part = slices[0].detach() if spec is None else tsharding.assemble(
                torch.stack([s.detach() for s in slices]), spec)
            tp_parts.append(part)
            for s in slices:
                assert torch.equal(tsharding.local_part(full.detach(), s), s.detach()), path
                assert tsharding.logical_shape(s) == tuple(full.shape), path
        cut = tsharding.tp_of(per[(0, 0)][path])
        if cut is None or cut.dim is None:
            assert all(torch.equal(p, full.detach()) for p in tp_parts), path
            continue
        cut_leaves += 1
        assert torch.equal(tsharding.tp_assemble(torch.stack(tp_parts), cut), full.detach()), path
    assert cut_leaves > 0


def test_partial_sum_gated_norm_over_two_halves_equals_the_whole_rows():
    """``gated_norm_sums_plain`` of two halves of d_inner added, then
    ``gated_norm_apply_plain`` on each half, is ``gated_rms_norm_plain`` of
    the whole rows; the backward's halves (``gated_norm_bwd_sums_plain``
    added, ``gated_norm_bwd_finish_plain``) are ``gated_rms_norm_bwd_plain``'s
    dy, dz and dw side by side."""
    rng = np.random.default_rng(0)
    y, z, g = (torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32))
    halves = [(y[..., s], z[..., s], g[..., s], w[s]) for s in (slice(0, 32), slice(32, 64))]
    sums = sum(tnorms.gated_norm_sums_plain(yh, zh) for yh, zh, _, _ in halves)
    out = torch.cat([tnorms.gated_norm_apply_plain(yh, zh, wh, sums, 64, 1e-5)
                     for yh, zh, _, wh in halves], dim=-1)
    want = tnorms.gated_rms_norm_plain(y, z, w, 1e-5)
    np.testing.assert_allclose(out, want, rtol=0, atol=HALVES_TOL * float(want.abs().max()))
    dots = sum(tnorms.gated_norm_bwd_sums_plain(yh, zh, gh, wh) for yh, zh, gh, wh in halves)
    got = [tnorms.gated_norm_bwd_finish_plain(yh, zh, gh, wh, sums, dots, 64, 1e-5)
           for yh, zh, gh, wh in halves]
    for i, want_i in enumerate(tnorms.gated_rms_norm_bwd_plain(y, z, g, w, 1e-5)):
        got_i = torch.cat([r[i] for r in got], dim=-1)
        np.testing.assert_allclose(got_i, want_i, rtol=0,
                                   atol=HALVES_TOL * float(want_i.abs().max()))


@pytest.mark.parametrize("task", ["t2i", "mmu"])
def test_fused_step_plain_on_two_halves_equals_one_rank(task):
    """K4's plain step, layer by layer, on each half of the heads (rank 0's
    and rank 1's slices of the layers and the caches), the two partial
    out_proj products and sums of yf^2 added as the all-gather of K4-tp does,
    against one rank's ``fused_decode_step_plain`` (fp32, 2 layers, LoRA on):
    h, the residual and both caches."""
    jm, tm = models()
    params = bridge(jax_params(jm, seed=1), tm)["mamba"]
    mcfg, lcfg = tm.cfg.mixer, tm.cfg.lora
    rng = np.random.default_rng(2)
    B, L = 3, tm.cfg.n_layer
    conv = torch.from_numpy(rng.standard_normal((L, B, mcfg.d_conv - 1, mcfg.d_conv_in))
                            .astype(np.float32))
    ssm = torch.from_numpy(rng.standard_normal((L, B, mcfg.nheads, mcfg.headdim, mcfg.d_state))
                           .astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((B, mcfg.d_model)).astype(np.float32))
    di, heads = mcfg.d_inner // 2, mcfg.nheads // 2
    halves = [tsharding.shard_params(_tp_mesh(2, r), {"layers": params["layers"]})["layers"]
              for r in range(2)]
    caches = [BackboneCache(torch.cat([conv[..., r * di:(r + 1) * di], conv[..., mcfg.d_inner:]],
                                      dim=-1), ssm[:, :, r * heads:(r + 1) * heads].clone())
              for r in range(2)]
    one = BackboneCache(conv.clone(), ssm.clone())
    want_h, want_res, _ = fused_decode_step_plain(params["layers"], h, None, one, task, mcfg, lcfg,
                                                  tm.cfg.norm_eps)
    out, res = h, None
    for layer in range(L):
        parts = [fused_decode_layer_plain(halves[r][layer], out, res, caches[r].conv_state[layer],
                                          caches[r].ssm_state[layer], task, mcfg, lcfg,
                                          tm.cfg.norm_eps, h0=r * heads, heads=heads)
                 for r in range(2)]
        res = parts[0][0]
        out = fused_decode_finish_plain(parts[0][1] + parts[1][1],
                                        sum(torch.sum(p[2] * p[2], dim=-1) for p in parts),
                                        mcfg.d_inner, mcfg.norm_eps, h.dtype)
    for got, want in ((out, want_h), (res, want_res),
                      (torch.cat([c.ssm_state for c in caches], dim=2), one.ssm_state),
                      (torch.cat([caches[0].conv_state[..., :di], caches[1].conv_state],
                                 dim=-1), one.conv_state)):
        np.testing.assert_allclose(got, want, rtol=0, atol=HALVES_TOL * float(want.abs().max()))


# ---------------------------------------------------------------------------
# training across tp ranks against JAX's single-device step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [{"tp": 2}, {"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 2}],
                         ids=str)
def test_mixed_step_under_tp_equals_jax(stage2_jax_tree, mesh_shape):  # noqa: F811
    """Stage 2's mixed step (t2i + mmu with both towers and the projector,
    finetune) under tp, alone and beside dp or fsdp: loss, every leaf's
    gradient and every updated leaf against JAX's single-device step; the
    tp ranks of a data rank see the same rows."""
    jm, tm = mmu_models()
    batch = {"t2i_flow": t2i_flow(11, 4, tm), "mmu_flow": mmu_flow(12, 4, jm)}
    cfg = dict(max_steps=4, warmup_steps=0, lr=1e-3, stage="finetune")
    ref = _jax_step(jm, stage2_jax_tree, cfg, batch)
    world = int(np.prod(list(mesh_shape.values())))
    results = run_ranks_checked(ranks.train_steps, world,
                                (tm, to_numpy(stage2_jax_tree), cfg, mesh_shape, [batch]))
    _hold(results, ref, cfg["lr"])
    calls = results[0]["collectives"]
    assert results[0]["tp_slices"] > 0 and calls["tp_all_reduce"]["calls"] > 0
    assert (results[0]["slices"] > 0) == ("fsdp" in mesh_shape)


@pytest.mark.parametrize("remat", [True, "proj"])
def test_stage1_step_under_tp_with_checkpointing_equals_jax(remat):
    """Stage 1 (finetune) at tp=2 with every block checkpointed, and under
    ``"proj"``: a checkpointed block's second forward runs the tp collectives
    again on every rank alike; the step equals JAX's."""
    jm, tm = models()
    jp = jax_params(jm, seed=7)
    cfg = dict(max_steps=4, warmup_steps=0, lr=1e-3, stage="finetune", t2i_task=True,
               mmu_task=False, remat=remat)
    batch = t2i_batch(9, 4, tm)
    ref = _jax_step(jm, jp, cfg, batch)
    results = run_ranks_checked(ranks.train_steps, 2, (tm, to_numpy(jp), cfg, {"tp": 2}, [batch]))
    _hold(results, ref, cfg["lr"])


def run_ranks_checked(fn, world, args):
    from omnimamba_tpu_torch.parallel.launch import run_ranks

    results = run_ranks(fn, world, args, timeout=TIMEOUT)
    _no_jax(results)
    return results


# ---------------------------------------------------------------------------
# decoding across tp ranks against JAX
# ---------------------------------------------------------------------------


def _decode_setup(seed, B, L0, n_layer=2):
    jc = tiny_config(n_layer=n_layer)
    jp = jinit_backbone(jax.random.PRNGKey(seed), jc, dtype=jnp.float32)
    ids = jnp.asarray(np.random.default_rng(seed - 4).integers(0, jc.vocab_size, (B, L0)), jnp.int32)
    return jc, jp, ids, jembed_text(jp, ids, jnp.float32)


def test_speculative_and_greedy_streams_under_tp_equal_jax():
    """JAX's ``test_speculative_decode_under_tp_mesh``: at tp=2 speculative
    decoding (2-layer draft, 4 drafts) gives the unsharded greedy stream
    exactly, and so do both decode paths of ``generate`` in fp32; every rank
    returns the same streams. The decode runs moved tp collectives (the
    fused path gathers a layer's partials once a step)."""
    jc, jp, ids, emb = _decode_setup(5, 1, 6)
    want = np.asarray(jgenerate(jp, jc, input_ids=ids, input_embeddings=emb, task="mmu",
                                max_length=24, sample=JSample(top_k=1)).sequences)
    jspec = np.asarray(jspeculative(jp, jc, input_ids=ids, input_embeddings=emb, task="mmu",
                                    max_length=24, k_draft=4, draft_layers=2).sequences)
    np.testing.assert_array_equal(jspec, want)
    runs = [("speculative", "speculative", dict(max_length=24, k_draft=4, draft_layers=2)),
            ("scan", "generate", dict(max_length=24, decode_impl="scan", cache_dtype=None)),
            ("fused", "generate", dict(max_length=24, decode_impl="fused", cache_dtype=None))]
    results = run_ranks_checked(ranks.tp_decode, 2, (torch_config(jc), to_numpy(jp), {"tp": 2},
                                                     np.asarray(ids, np.int64), np.asarray(emb),
                                                     runs))
    for name, _, _ in runs:
        np.testing.assert_array_equal(results[0]["streams"][name], want, err_msg=name)
        np.testing.assert_array_equal(results[1]["streams"][name], results[0]["streams"][name])
        assert results[0]["collectives"][name]["tp_broadcast"]["calls"] > 0, name
    assert results[0]["collectives"]["fused"]["tp_all_gather"]["calls"] == 2 * (24 - 6 - 1)
    assert results[0]["quant_cut_equal"]


def test_int8_state_generate_under_tp_agrees_with_jax():
    """JAX's ``test_int8_state_decode_under_tp_mesh``: ``cache_dtype="int8"``
    at tp=2 (the rank's heads of the scaled-int8 state) agrees with the
    unsharded fp32-state greedy stream on more than 70% of the tokens; both
    ranks give one stream; int8 weights (quantized whole, then cut) on the
    fused path give the stream of one card's int8 weights."""
    jc, jp, ids, emb = _decode_setup(6, 2, 6)
    want = np.asarray(jgenerate(jp, jc, input_ids=ids, input_embeddings=emb, task="mmu",
                                max_length=20, sample=JSample(top_k=1)).sequences)
    runs = [("int8_state", "generate", dict(max_length=20, cache_dtype="int8")),
            ("int8_weights", "generate", dict(max_length=20, decode_impl="fused", cache_dtype=None,
                                              int8_weights=True))]
    results = run_ranks_checked(ranks.tp_decode, 2, (torch_config(jc), to_numpy(jp), {"tp": 2},
                                                     np.asarray(ids, np.int64), np.asarray(emb),
                                                     runs))
    got = results[0]["streams"]["int8_state"]
    assert (got == want).mean() > 0.7, float((got == want).mean())
    for name, _, _ in runs:
        np.testing.assert_array_equal(results[1]["streams"][name], results[0]["streams"][name])
    # one card's int8 weights, fused path: the same stream
    from omnimamba_tpu_torch import SampleParams, generate
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params

    cfg = torch_config(jc)
    q = quantize_decode_params(bridge_backbone(jp, cfg))
    one = generate(q, cfg, input_ids=torch.from_numpy(np.asarray(ids, np.int64)),
                   input_embeddings=torch.from_numpy(np.array(emb)), task="mmu", max_length=20,
                   sample=SampleParams(top_k=1), decode_impl="fused", cache_dtype=None,
                   device="cpu").sequences.numpy()
    np.testing.assert_array_equal(results[0]["streams"]["int8_weights"], one)


def test_sequence_parallel_prefill_under_tp_equals_jax():
    """``backbone_forward_sp`` on a (tp=2, sp=2) mesh of 4 ranks: each mixer
    on its rank's heads, each slice of the sequence on its sp rank; the two
    tp ranks of a slice give the same hidden states, and the slices together
    are JAX's one-device ``backbone_forward`` (the tolerance of
    ``tests/test_torch_sequence_parallel.py``)."""
    from omnimamba_tpu.models import backbone as jbackbone
    from tests.test_torch_sequence_parallel import _backbone, _close

    jm, tm, jp = _backbone(2)
    emb = np.random.default_rng(3).standard_normal((2, 96, tm.cfg.d_model)).astype(np.float32)
    want, _ = jbackbone.backbone_forward(jp, jnp.asarray(emb), "mmu", jm.cfg, scan_impl="chunked")
    results = run_ranks_checked(ranks.backbone_sp, 4, (tm, to_numpy(jp), emb, True, 2))
    by = {(r["tp"], r["sp"]): r["hidden"] for r in results}
    for sp in range(2):
        np.testing.assert_array_equal(by[(1, sp)], by[(0, sp)])
    _close(np.concatenate([by[(0, 0)], by[(0, 1)]], axis=1), np.asarray(want), "hidden")


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [{"tp": 2}, {"fsdp": 2, "tp": 2}], ids=str)
def test_checkpoint_saved_under_tp_restores_on_one_rank_bit_for_bit(tmp_path, mesh_shape):
    """tp ranks (and fsdp x tp) step and save; one process restores the file
    into a one-card state: every parameter and every AdamW moment bit for bit,
    the file the one-card format."""
    jm, tm = models()
    jp = jax_params(jm, seed=8)
    cfg = dict(max_steps=4, warmup_steps=0, lr=1e-3, stage="finetune", t2i_task=True,
               mmu_task=False)
    world = int(np.prod(list(mesh_shape.values())))
    results = run_ranks_checked(ranks.checkpoint_save, world,
                                (tm, to_numpy(jp), cfg, mesh_shape, t2i_batch(6, 4, tm),
                                 str(tmp_path)))
    state, _ = ttrainer.create_train_state(bridge(jp, tm), tcfg.TrainConfig(**cfg))
    restored = CheckpointManager(str(tmp_path)).restore(state, None, torch.Generator())
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


def test_training_cli_with_tp_under_two_ranks(tmp_path):
    """``scripts/train.py --tp 2`` as two ranks of one group: the tiny YAML,
    both flows, synthetic data, 2 steps; the same global metrics on both
    ranks, every rank's leaves tp slices, one run directory."""
    results = run_ranks_checked(ranks.training_cli, 2, (str(tmp_path), ["--tp", "2"]))
    assert [r["step"] for r in results] == [2, 2]
    assert results[0]["metrics"] == results[1]["metrics"]
    assert np.isfinite(results[0]["metrics"]["loss"]) and results[0]["metrics"]["loss_mmu"] > 0
    assert results[0]["slices"] == 0 and results[0]["tp_slices"] > 0
    assert len(list(tmp_path.iterdir())) == 1


def test_a_tp_that_does_not_divide_the_heads_raises():
    _, tm = models()
    with pytest.raises(ValueError, match="does not divide"):
        ttrainer.check_train_mesh(FakeMesh(dp=1, fsdp=1, tp=3), tm.cfg.mixer.nheads)

"""The port's selective checkpoint policies (``ops/remat.py``) on the CPU, in
fp32, at the tiny geometry of ``tests/test_torch_helpers.py``.

- Every policy gives ``remat=False``'s loss and gradients bit for bit, with
  and without a dropout generator (the second forward draws the first one's
  masks and leaves the generator where an unchecked run leaves it).
- Under each policy the port matches the JAX ``t2i_loss`` under the same
  policy, to the tolerances of ``tests/test_torch_train.py``.
- A mixed stage-2 step with per-flow checkpointing gives the parameters of a
  step without it, bit for bit (the counterpart of
  ``tests/test_remat.py::test_mixed_step_per_flow_remat_matches_no_remat``).
- What each policy keeps, against the JAX package's policy table; how often
  the scan's forward runs under each; the ladder of ``remat="proj"``.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.models import omnimamba as jomni
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.models import omnimamba as tomni
from omnimamba_tpu_torch.models.backbone import backbone_forward
from omnimamba_tpu_torch.ops import remat as tremat
from omnimamba_tpu_torch.ops import ssd_kernel
from omnimamba_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_train
from omnimamba_tpu_torch.train import optimizer as topt
from omnimamba_tpu_torch.train import trainer as ttrainer
from omnimamba_tpu_torch.utils.bridge import to_jax_tree
from tests.test_torch_helpers import bridge, tt
from tests.test_torch_train import (
    assert_trees_close, grad_tol, jax_params, models, port_grads, require_grad, t2i_batch)

POLICIES = [True, "proj", "proj_xbd", "proj_ssd", "proj_conv_ssd", "dots"]
JAX_BACKBONE = Path(__file__).resolve().parent.parent / "omnimamba_tpu" / "models" / "backbone.py"


def _t2i(tp, tm, flow, remat, generator=None):
    return tomni.t2i_loss(tp, tm, tt(flow["inputs"]), tt(flow["caption_ids"]),
                          dtype=torch.float32, generator=generator, remat=remat)


def _leaves_equal(a, b):
    return [k for (k, x), (_, y) in zip(topt.named_leaves(a), topt.named_leaves(b))
            if not torch.equal(x, y)]


@pytest.mark.parametrize("dropout_seed", [None, 7], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("remat", POLICIES, ids=str)
def test_policy_gives_no_remat_bits(remat, dropout_seed):
    jm, tm = models(dropout=0.25)
    tp = require_grad(bridge(jax_params(jm), tm))
    flow = t2i_batch(4, 2, tm)["t2i_flow"]

    def run(policy):
        g = None if dropout_seed is None else torch.Generator().manual_seed(dropout_seed)
        loss = _t2i(tp, tm, flow, policy, g)
        return loss.detach(), port_grads(loss, tp), None if g is None else g.get_state()

    l0, g0, s0 = run(False)
    l1, g1, s1 = run(remat)
    assert torch.equal(l0, l1)
    assert not _leaves_equal(g0, g1), _leaves_equal(g0, g1)
    if dropout_seed is not None:
        assert torch.equal(s0, s1)


@pytest.mark.parametrize("remat,scan_impl,tol", [
    *[(p, "chunked", 1e-4) for p in POLICIES],
    ("proj_ssd", "pallas_ad", 2e-3),  # where JAX names the scan's output and states
], ids=str)
def test_policy_against_jax(remat, scan_impl, tol):
    """Loss to 2e-5 and every gradient to ``tol`` of the largest, as
    ``test_torch_train.test_t2i_loss_and_every_gradient`` holds them."""
    jm, tm = models()
    jp = jax_params(jm)
    tp = require_grad(bridge(jp, tm))
    flow = t2i_batch(1, 3, tm)["t2i_flow"]

    def jloss(p):
        return jomni.t2i_loss(p, jm, jnp.asarray(flow["inputs"]),
                              jnp.asarray(flow["caption_ids"]), dtype=jnp.float32,
                              scan_impl=scan_impl, remat=remat)

    lj, gj = jax.value_and_grad(jloss)(jp)
    lt = _t2i(tp, tm, flow, remat)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-5)
    assert_trees_close(to_jax_tree(port_grads(lt, tp), tm), gj, rtol=tol,
                       atol=grad_tol(gj, tol), what=f"gradient under {remat}")


def _jax_policy_table():
    """{policy: names} as JAX's ``backbone_forward`` writes them
    (``save_only_these_names`` after each ``remat == "..."``)."""
    src = JAX_BACKBONE.read_text()
    table = {}
    for name, args in re.findall(
            r'remat == "(\w+)":.*?save_only_these_names\(([^)]*)\)', src, flags=re.S):
        table[name] = tuple(re.findall(r'"(\w+)"', args))
    assert 'remat == "dots"' in src and "dots_with_no_batch_dims_saveable" in src
    return table


def test_policy_table_equals_jax():
    jax_table = _jax_policy_table()
    assert set(jax_table) == set(tremat.POLICIES) - {"dots"}
    for name, names in jax_table.items():
        assert sorted(tremat.POLICIES[name]) == sorted(names), name
    assert tremat.POLICIES["dots"] == tremat.DOTS


@pytest.mark.parametrize("remat", POLICIES)
def test_each_policy_keeps_its_named_tensors(remat):
    """The outputs the checkpointed blocks hold, by name and shape: each
    named intermediate once a layer (the LoRA B product twice: z and
    x | bc | dt), nothing under True."""
    jm, tm = models()
    tp = require_grad(bridge(jax_params(jm), tm))
    B, flow = 2, t2i_batch(2, 2, tm)["t2i_flow"]
    with tremat.record_kept() as log:
        loss = _t2i(tp, tm, flow, remat)
    port_grads(loss, tp)
    c = tm.cfg.mixer
    L = flow["caption_ids"].shape[1] + flow["inputs"].shape[1]
    gn, r = c.ngroups * c.d_state, tm.cfg.lora.r
    shapes = {
        ("in_proj_z_out",): [[(B, L, c.d_inner)]],
        ("in_proj_out",): [[(B, L, c.d_inner + 2 * gn + c.nheads)]],
        ("conv_out",): [[(B, L, c.d_inner)]],
        ("ssd_out", "ssd_resid"): [[(B, L, c.nheads, c.headdim), (B, c.nheads, c.headdim, c.d_state),
                                    (B, -(-L // 16), c.nheads, c.headdim, c.d_state)]],
        ("lora_a_out",): [[(B, L, r)]],
        ("lora_b_out",): [[(B, L, c.d_inner)], [(B, L, c.d_inner + 2 * gn + c.nheads)]],
        ("out_proj_out",): [[(B, L, c.d_model)]],
    }
    want = set(() if remat is True else tremat.POLICIES[remat])
    expect = sorted((names, s) for names, per in shapes.items() if want & set(names)
                    for s in per * tm.cfg.n_layer)
    assert sorted((names, s) for names, s in log) == expect
    assert {n for names, _ in log for n in names} == want


@pytest.mark.parametrize("remat,runs", [(False, 1), (True, 2), ("proj", 2), ("proj_xbd", 2),
                                        ("proj_ssd", 1), ("proj_conv_ssd", 1), ("dots", 2)],
                         ids=str)
def test_scan_forward_runs_once_where_its_outputs_are_kept(remat, runs, monkeypatch):
    """On the card K1 launches once a layer under proj_ssd and proj_conv_ssd
    and twice under the other checkpointing choices; on the CPU its plain
    version runs as often."""
    jm, tm = models()
    tp = require_grad(bridge(jax_params(jm), tm))
    calls = []
    inner = ssd_kernel._scan_forward

    def counted(*args):
        calls.append(1)
        return inner(*args)

    monkeypatch.setattr(ssd_kernel, "_scan_forward", counted)
    flow = t2i_batch(3, 2, tm)["t2i_flow"]
    port_grads(_t2i(tp, tm, flow, remat), tp)
    assert len(calls) == runs * tm.cfg.n_layer


def test_unknown_policy_raises():
    _, tm = models()
    with pytest.raises(ValueError, match="proj_xbd"):
        ttrainer.resolve_remat("proj_x", 100)
    with pytest.raises(ValueError, match="remat="):
        backbone_forward({}, torch.zeros(1, 2, 4), "t2i", tm.cfg, remat="everything")


def test_ladder_thresholds():
    """Each rung holds below its limit, the next from it on; the limits rise
    and every rung is a policy the backbone takes."""
    ladder = ttrainer.REMAT_LADDER
    limits = [limit for _, limit in ladder]
    assert limits == sorted(limits) and len(set(limits)) == len(limits)
    assert ladder[0][0] is False
    nxt = [rung for rung, _ in ladder[1:]] + [True]
    for (rung, limit), after in zip(ladder, nxt):
        assert tremat.check_remat(rung) == rung
        assert ttrainer.resolve_remat("proj", limit - 1) == rung
        assert ttrainer.resolve_remat("proj", limit) == after
    assert ttrainer.resolve_remat("proj", 0) is False
    assert ttrainer.resolve_remat("proj", 10**9) is True
    for policy in ("proj_xbd", "proj_ssd", "proj_conv_ssd", "dots", True, False):
        assert ttrainer.resolve_remat(policy, 10**9) == policy


@pytest.mark.parametrize("remat,remat_mmu", [("proj", None), ("proj_ssd", "proj_xbd"),
                                             ("dots", "proj_conv_ssd")], ids=str)
def test_mixed_step_per_flow_remat_equals_no_remat(remat, remat_mmu, monkeypatch):
    """One optimizer step of the mixed stage-2 batch with per-flow
    checkpointing gives the metrics and the parameters of the same step
    without any, bit for bit. ``"proj"`` resolves by the t2i flow's tokens; a
    ladder whose first rung ends at 0 tokens puts this tiny flow on
    ``proj_ssd``."""
    from tests.test_torch_stage2 import models as mmu_models
    from tests.test_torch_stage2 import mmu_flow, t2i_flow

    jm, tm = mmu_models()
    tm = tm._replace(cfg=dataclasses.replace(
        tm.cfg, lora=dataclasses.replace(tm.cfg.lora, dropout=0.25)))
    jp = jomni.init_omnimamba(jax.random.PRNGKey(0), jm)
    batch = {"t2i_flow": t2i_flow(10, 3, tm), "mmu_flow": mmu_flow(20, 3, jm)}
    monkeypatch.setattr(ttrainer, "REMAT_LADDER", ((False, 0), ("proj_ssd", 10**9)))
    assert ttrainer.resolve_remat("proj", 3 * 25) == "proj_ssd"

    def one_step(r, r_mmu):
        tc = tcfg.TrainConfig(max_steps=2, warmup_steps=0, lr=8e-4, stage="finetune",
                              remat=r, remat_mmu=r_mmu)
        state, tx = ttrainer.create_train_state(bridge(jp, tm), tc)
        step = ttrainer.make_train_step(tm, tx, tc, dtype=torch.float32, device="cpu")
        state, metrics = step(state, batch, torch.Generator().manual_seed(5))
        return state.params, metrics

    p0, m0 = one_step(False, False)
    p1, m1 = one_step(remat, remat_mmu)
    for k in ("loss", "loss_t2i", "loss_mmu", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    assert float(m0["loss_mmu"]) > 0
    assert not _leaves_equal(p0, p1), _leaves_equal(p0, p1)


@pytest.mark.parametrize("frozen", [False, True], ids=["trained", "frozen"])
def test_conv_function_against_autograd(frozen):
    """``causal_conv1d_train``: the forward's bits, and its written-out
    backward against autograd through the shifted adds (fp32 sums in another
    order: 1e-6 of the largest), on a column slice as the mixer gives it; a
    frozen weight and bias get no gradient."""
    rng = np.random.default_rng(0)
    full = tt(rng.standard_normal((2, 11, 20)).astype(np.float32))
    x = full[..., 3:15].detach().requires_grad_()
    w = tt(rng.standard_normal((4, 12)).astype(np.float32)).requires_grad_(not frozen)
    b = tt(rng.standard_normal(12).astype(np.float32)).requires_grad_(not frozen)
    g = tt(rng.standard_normal((2, 11, 12)).astype(np.float32))
    leaves = (x,) if frozen else (x, w, b)
    for bias in (b, None):
        y_fn, y_ref = causal_conv1d_train(x, w, bias, ("conv_out",)), causal_conv1d(x, w, bias)
        assert torch.equal(y_fn, y_ref)
        got = torch.autograd.grad(y_fn, leaves if bias is not None else leaves[:2], g)
        want = torch.autograd.grad(y_ref, leaves if bias is not None else leaves[:2], g)
        for a, e in zip(got, want):
            torch.testing.assert_close(a, e, rtol=0, atol=1e-6 * e.abs().max().item())

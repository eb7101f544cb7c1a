"""The sequence-parallel prefill of the port (``parallel/sequence.py``,
``mamba2.mamba2_forward_sp_local``, ``backbone.backbone_forward_sp``) against
the JAX package's single-device functions, on the CPU, in fp32.

The port's ranks are gloo processes (``parallel/launch.run_ranks``; their
programs in ``tests/torch_parallel_ranks.py`` import no JAX), each holding the
next slice of the sequence. The references are computed in this process
before the ranks start: ``ssd_chunked`` and ``backbone_forward`` on the whole
sequence. Tolerance: 1e-5 of the reference's largest magnitude plus 1e-4 of
each value (the state passing sums in another order than one scan).

R7 (a fault of the reference, not copied): past the 1,500-entry mmu
positional table, JAX's ``backbone_forward`` gives zero positions and its
``backbone_forward_sp`` clamps each slice's start to the table's end, so the
two disagree. The port's sp prefill gives what its one-rank
``backbone_forward`` gives. ``test_r7_*`` pins it, running JAX's sp function
on two virtual devices as ``tests/test_sequence_parallel.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from omnimamba_tpu.models import backbone as jbackbone
from omnimamba_tpu.ops.ssd_chunked import ssd_chunked
from omnimamba_tpu_torch.models import backbone as tbackbone
from omnimamba_tpu_torch.parallel.launch import run_ranks
from tests import torch_parallel_ranks as ranks
from tests.test_torch_helpers import bridge_backbone, fill_lora_b, tiny_models, to_numpy

TIMEOUT = 300.0
CHUNK = 16  # the chunk of the port's plain scan; the local lengths below are not multiples of it


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=what)


def _ssd_inputs(seed, B, L, H, P, G, N):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)) - 1.0))
    return {"x": rng.standard_normal((B, L, H, P)), "dt": dt,
            "A": -np.exp(rng.uniform(0.0, 1.0, H)), "B": rng.standard_normal((B, L, G, N)) / 4,
            "C": rng.standard_normal((B, L, G, N)) / 4, "D": rng.standard_normal(H)}


@pytest.mark.parametrize("with_d", [True, False], ids=["D", "no_D"])
@pytest.mark.parametrize("n_sp", [2, 4])
def test_ssd_sp_local_equals_jax_ssd_chunked(n_sp, with_d):
    """Each rank's slice of y and the final state (the same on every rank)
    against the whole sequence's scan; 24 positions a rank (a chunk and a
    half), 2 groups of 2 heads."""
    inputs = {k: v.astype(np.float32) for k, v in _ssd_inputs(n_sp, 2, 24 * n_sp, 4, 8, 2, 16).items()}
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    y, state = ssd_chunked(j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"] if with_d else None,
                           chunk_size=CHUNK)
    results = run_ranks(ranks.ssd_sp, n_sp, (inputs,), timeout=TIMEOUT)
    assert not any(r["jax_loaded"] for r in results)
    key = "with_D" if with_d else "without_D"
    _close(np.concatenate([r[key][0] for r in results], axis=1), np.asarray(y), "y")
    for r in results:
        _close(r[key][1], np.asarray(state), f"final state on rank {r['rank']}")
    # one gather of (state, decay) a call: two calls, then the halo
    assert results[0]["counts"]["all_gather"]["calls"] == 3


def test_halo_left_gives_each_rank_its_left_neighbours_tail():
    """Three ranks: rank r > 0 gets rank r - 1's last 3 positions, rank 0 zeros."""
    n = 3
    inputs = {k: v.astype(np.float32) for k, v in _ssd_inputs(7, 2, 24 * n, 4, 8, 2, 16).items()}
    results = run_ranks(ranks.ssd_sp, n, (inputs,), timeout=TIMEOUT)
    x = inputs["x"].reshape(2, 24 * n, -1)
    np.testing.assert_array_equal(results[0]["halo"], np.zeros((2, 3, x.shape[-1]), np.float32))
    for r in results[1:]:
        start = 24 * r["rank"]
        np.testing.assert_array_equal(r["halo"], x[:, start - 3:start])


def _backbone(seed):
    """The tiny backbone of both packages with LoRA B off zero (the mmu LoRA counts)."""
    jm, tm = tiny_models()
    jp = jbackbone.init_backbone(jax.random.PRNGKey(seed), jm.cfg)
    jp = {**jp, "layers": {**jp["layers"],
                           "mixer": fill_lora_b(jp["layers"]["mixer"], np.random.default_rng(seed))}}
    return jm, tm, jp


CASES = [(2, 48, True), (4, 48, False)]  # (ranks, positions a rank, add_mmu_pos)


@pytest.mark.parametrize("n_sp,per_rank,add_pos", CASES,
                         ids=["2_ranks_positions_inside_the_table", "4_ranks_no_positions_past_it"])
def test_backbone_forward_sp_equals_jax_backbone_forward(n_sp, per_rank, add_pos):
    """The whole-model sp prefill (mmu) against JAX's one-device forward on
    the whole sequence: 96 positions inside the 128-entry table with the mmu
    positions, and 192 past it without them (a long-context window)."""
    jm, tm, jp = _backbone(n_sp)
    L = n_sp * per_rank
    assert (L <= tm.cfg.mmu_pos_len) == add_pos
    emb = np.random.default_rng(1).standard_normal((2, L, tm.cfg.d_model)).astype(np.float32)
    want, _ = jbackbone.backbone_forward(jp, jnp.asarray(emb), "mmu", jm.cfg,
                                         add_mmu_pos=add_pos, scan_impl="chunked")
    results = run_ranks(ranks.backbone_sp, n_sp, (tm, to_numpy(jp), emb, add_pos), timeout=TIMEOUT)
    assert not any(r["jax_loaded"] for r in results)
    _close(np.concatenate([r["hidden"] for r in results], axis=1), np.asarray(want), "hidden")


@pytest.mark.collective
def test_r7_jax_sp_clamps_positions_past_the_table_the_port_does_not():
    """192 mmu positions on 2 slices of 96, past the 128-entry table, with
    the positions added. The port's sp prefill equals the one-rank
    ``backbone_forward`` of both packages (zeros past the table); JAX's sp
    function gives slice 1 the table's last 96 entries instead (its start
    clamped to 128 - 96 = 32) and so differs there, and only there."""
    jm, tm, jp = _backbone(11)
    L, n = 192, 2
    assert L > tm.cfg.mmu_pos_len
    emb = np.random.default_rng(2).standard_normal((1, L, tm.cfg.d_model)).astype(np.float32)
    one_rank, _ = jbackbone.backbone_forward(jp, jnp.asarray(emb), "mmu", jm.cfg,
                                             scan_impl="chunked")
    one_rank = np.asarray(one_rank)
    jax_sp = np.asarray(jbackbone.backbone_forward_sp(
        jp, jnp.asarray(emb), "mmu", jm.cfg, Mesh(np.asarray(jax.devices()[:n]), ("sp",))))
    results = run_ranks(ranks.backbone_sp, n, (tm, to_numpy(jp), emb, True), timeout=TIMEOUT)
    port_sp = np.concatenate([r["hidden"] for r in results], axis=1)
    with torch.no_grad():
        port_one, _ = tbackbone.backbone_forward(bridge_backbone(jp, tm.cfg), torch.from_numpy(emb),
                                                 "mmu", tm.cfg)
    _close(port_sp, one_rank, "port sp against JAX's one-device forward")
    _close(port_sp, port_one.numpy(), "port sp against the port's one-rank forward")
    half = L // n
    _close(jax_sp[:, :half], one_rank[:, :half], "slice 0: JAX's sp prefill")
    scale = float(np.abs(one_rank).max())
    assert np.abs(jax_sp[:, half:] - one_rank[:, half:]).max() > 1e-2 * scale  # R7

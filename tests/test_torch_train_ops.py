"""The training ops of the PyTorch port against the JAX package, on the CPU.

The backward kernels' plain versions (what the port's autograd Functions run
for a CPU tensor) against the JAX package's Pallas backward kernels in
interpret mode, as ``tests/test_ssd_pallas_bwd.py`` and
``tests/test_norms_pallas.py`` run them, and against ``jax.grad`` of the
chunked scan. Inputs come from a numpy seed, everything is fp32. Tolerances
are the JAX package's own for the same kernel: 2e-3 for the interpreted SSD
backward, 1e-4 of a gradient's largest value for the norms; against
``jax.grad`` of ``ssd_chunked`` (same fp32 arithmetic, other summation order)
1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.ops.norms_pallas import fused_add_rms_norm as j_fused_add
from omnimamba_tpu.ops.norms_pallas import fused_gated_rms_norm as j_fused_gated
from omnimamba_tpu.ops.ssd_chunked import ssd_chunked as j_ssd_chunked
from omnimamba_tpu.ops.ssd_pallas import ssd_pallas
from omnimamba_tpu.ops.ssd_pallas_bwd import ssd_pallas_ad
from omnimamba_tpu_torch.ops import norms as tnorms
from omnimamba_tpu_torch.ops.norms_kernel import (
    fused_add_rms_norm,
    fused_add_rms_norm_bwd,
    fused_gated_rms_norm,
    fused_gated_rms_norm_bwd,
)
from omnimamba_tpu_torch.ops.ssd_chunked import ssd_chunked
from omnimamba_tpu_torch.ops.ssd_kernel import (
    PLAIN_CHUNK,
    ssd_bwd_plain,
    ssd_fused,
    ssd_fused_bwd,
    ssd_fused_plain,
)
from tests.test_torch_helpers import nn, tt
from tests.test_torch_ops import ssd_inputs

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")

# name: (L, G, with D, with a cotangent of the final state)
SSD_CASES = {
    "aligned_G2": (48, 2, True, True),
    "no_gstate": (48, 2, True, False),
    "no_D": (48, 1, False, True),
    "ragged": (37, 2, True, True),
    "shorter_than_a_chunk": (5, 1, True, False),
}


def _case(name, seed=3):
    L, G, with_D, with_gs = SSD_CASES[name]
    d, _ = ssd_inputs(seed, L=L, G=G)
    if not with_D:
        d["D"] = None
    rng = np.random.default_rng(seed + 100)
    wy = rng.standard_normal(d["x"].shape).astype(np.float32)
    B, _, H, P = d["x"].shape
    ws = rng.standard_normal((B, H, P, d["Bmat"].shape[-1])).astype(np.float32) if with_gs else None
    return d, wy, ws


def _jax_grads(fn, d, wy, ws):
    args = [None if v is None else jnp.asarray(v) for v in d.values()]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)

    def loss(*a):
        y, state = fn(*a)
        out = jnp.sum(y.astype(jnp.float32) * wy)
        return out + (jnp.sum(state * ws) if ws is not None else 0.0)

    got = jax.grad(loss, argnums=argnums)(*args)
    return dict(zip([GRADS[i] for i in argnums], got))


def _port_grads_plain(d, wy, ws):
    """The plain backward fed with the plain forward's chunk states."""
    t = [None if v is None else tt(v) for v in d.values()]
    _, _, states = ssd_fused_plain(*t, return_chunk_states=True)
    got = ssd_bwd_plain(*t, states, tt(wy), None if ws is None else tt(ws))
    return {k: g for k, g in zip(GRADS, got) if g is not None}


def _assert_grads(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(nn(got[k]), np.asarray(want[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_bwd_plain_vs_interpreted_pallas(name):
    """All six gradients of K5's plain version against ``jax.grad`` of
    ``ssd_pallas_ad`` in interpret mode; 2e-3 is that kernel's own test's."""
    d, wy, ws = _case(name)
    fn = functools.partial(ssd_pallas_ad, chunk_size=16, head_tile=None, interpret=True)
    _assert_grads(_port_grads_plain(d, wy, ws), _jax_grads(fn, d, wy, ws), 2e-3)


def _bf16_grads(name):
    """The port's plain backward and ``jax.grad`` of the interpreted Pallas
    backward on one case with x, B and C cast to bf16 on both sides (dt, A, D
    and the cotangent of the final state stay fp32). The cotangent of y is
    bf16 on both sides: ``wy`` rounded, as ``jax.grad`` hands it back through
    ``y.astype(float32)``."""
    d, wy, ws = _case(name)
    d16 = dict(d)
    for k in ("x", "Bmat", "Cmat"):
        d16[k] = jnp.asarray(d[k]).astype(jnp.bfloat16)
    fn = functools.partial(ssd_pallas_ad, chunk_size=16, head_tile=None, interpret=True)
    want = _jax_grads(fn, d16, wy, ws)
    t = [None if v is None else tt(np.asarray(v, np.float32)) for v in d16.values()]
    for i, k in enumerate(d16):
        if k in ("x", "Bmat", "Cmat"):
            t[i] = t[i].to(torch.bfloat16)
    _, _, states = ssd_fused_plain(*t, return_chunk_states=True)
    got = ssd_bwd_plain(*t, states, tt(wy).to(torch.bfloat16), None if ws is None else tt(ws))
    return {k: g for k, g in zip(GRADS, got) if g is not None}, want


# bf16 operands on both sides, rounded at the same points; the sums are fp32
# in another order, and the chunk states come from two forwards (the port's
# plain one, the Pallas one), so an operand that lies near the midpoint of
# two bf16 numbers may round the other way, and dx is rounded once here and
# twice in JAX (dt K, then + D g). Each element: |error| <= 2^-7 |reference|
# (one bf16 unit of a bf16 output) + 2^-9 max |reference| (half a unit at the
# top of the range). Without the rounding points the plain version misses
# this bound on two of the five cases.
BF16_RTOL, BF16_ATOL_REL = 2.0 ** -7, 2.0 ** -9


@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_bwd_plain_bf16_vs_interpreted_pallas(name):
    """K5's plain version with bf16 inputs against ``jax.grad`` of
    ``ssd_pallas_ad`` in interpret mode, which takes ``mxu_dtype=bf16``."""
    got, want = _bf16_grads(name)
    assert set(got) == set(want)
    for k in want:
        g, w = nn(got[k].float()), np.asarray(want[k], np.float32)
        assert got[k].dtype == (torch.bfloat16 if k in ("dx", "dB", "dC") else torch.float32), k
        allowed = BF16_RTOL * np.abs(w) + BF16_ATOL_REL * max(float(np.abs(w).max()), 1e-30)
        share = float((np.abs(g - w) / allowed).max())
        assert share <= 1.0, (k, share)


@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_bwd_plain_vs_grad_of_chunked(name):
    """... and against ``jax.grad`` of the chunked scan: fp32 on both sides."""
    d, wy, ws = _case(name)
    fn = functools.partial(j_ssd_chunked, chunk_size=16)
    _assert_grads(_port_grads_plain(d, wy, ws), _jax_grads(fn, d, wy, ws), 1e-4)


@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_fused_is_differentiable(name):
    """``ssd_fused`` under autograd (the Function around forward and backward)
    gives the gradients of the chunked scan, in its inputs' dtypes, and what
    the wrapper ``ssd_fused_bwd`` returns on its own."""
    d, wy, ws = _case(name)
    leaves = {k: tt(v).requires_grad_() for k, v in d.items() if v is not None}
    args = [leaves.get(k) for k in d]
    y, state = ssd_fused(*args)
    loss = (y * tt(wy)).sum() + ((state * tt(ws)).sum() if ws is not None else 0.0)
    got = dict(zip([GRADS[i] for i, a in enumerate(args) if a is not None],
                   torch.autograd.grad(loss, [a for a in args if a is not None])))
    fn = functools.partial(j_ssd_chunked, chunk_size=16)
    _assert_grads(got, _jax_grads(fn, d, wy, ws), 1e-4)
    for k, a in zip(GRADS, args):
        if a is not None:
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
    plain = _port_grads_plain(d, wy, ws)
    for k in got:
        assert torch.equal(got[k], plain[k]), k


def test_ssd_bwd_final_state_only():
    """A loss through the final state alone: the cotangent of y is absent."""
    d, _, ws = _case("aligned_G2")
    leaves = [tt(v).requires_grad_() for v in d.values()]
    _, state = ssd_fused(*leaves)
    got = torch.autograd.grad((state * tt(ws)).sum(), leaves)
    fn = functools.partial(j_ssd_chunked, chunk_size=16)
    want = _jax_grads(fn, d, np.zeros_like(d["x"]), ws)
    _assert_grads(dict(zip(GRADS, got)), want, 1e-4)


@pytest.mark.parametrize("L,G", [(48, 2), (37, 1), (5, 2)])
def test_chunk_states_vs_pallas(L, G):
    """The states entering each chunk, as the backward reads them, against
    ``ssd_pallas(return_chunk_states=True)`` in interpret mode (2e-4: that
    kernel's own forward tolerance)."""
    d, _ = ssd_inputs(4, L=L, G=G)
    j = [jnp.asarray(v) for v in d.values()]
    t = [tt(v) for v in d.values()]
    yj, sj, hj = ssd_pallas(*j, chunk_size=PLAIN_CHUNK, interpret=True, return_chunk_states=True)
    yt, st, ht = ssd_fused(*t, return_chunk_states=True)
    assert ht.shape == (2, -(-L // PLAIN_CHUNK), 4, 8, 16) and ht.dtype == torch.float32
    assert float(ht[:, 0].abs().max()) == 0.0  # a fresh sequence starts from zero
    for got, want in ((yt, yj), (st, sj), (ht, hj)):
        np.testing.assert_allclose(nn(got), np.asarray(want, np.float32), rtol=2e-4, atol=2e-4)
    # the same values as the plain chunked code, which also has the option
    y2, s2, h2 = ssd_chunked(*t, chunk_size=PLAIN_CHUNK, return_chunk_states=True)
    assert torch.equal(ht, h2) and torch.equal(yt, y2) and torch.equal(st, s2)


def test_ssd_fused_bwd_checks_what_it_is_given():
    """The wrapper's plain path takes what the Function hands it; a wrong
    chunk-state layout is a shape error in tensor code, not a silent result."""
    d, wy, _ = _case("ragged")
    t = [tt(v) for v in d.values()]
    _, _, states = ssd_fused(*t, return_chunk_states=True)
    got = ssd_fused_bwd(*t, states, tt(wy), None)
    assert [g.shape for g in got] == [v.shape for v in t]
    with pytest.raises((RuntimeError, IndexError)):
        ssd_fused_bwd(*t, states[:, :1], tt(wy), None)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(nn(got) - want).max()) / max(float(np.abs(want).max()), 1e-6)


@pytest.mark.parametrize("with_dres", [False, True], ids=["no_dres", "dres"])
@pytest.mark.parametrize("with_res", [False, True], ids=["first_block", "residual"])
def test_add_norm_bwd_plain_vs_interpreted_pallas(with_res, with_dres):
    """K6a's plain version against the VJP of ``norms_pallas.fused_add_rms_norm``
    in interpret mode: with and without an incoming residual, with and
    without a cotangent of the stream. 1e-4 of the gradient's largest value:
    the JAX package's own fp32 bound."""
    rng = np.random.default_rng(0)
    B, L, d = 2, 13, 256
    x = rng.standard_normal((B, L, d)).astype(np.float32)
    res = rng.standard_normal((B, L, d)).astype(np.float32) if with_res else None
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal((B, L, d)).astype(np.float32)
    gy = rng.standard_normal((B, L, d)).astype(np.float32) if with_dres else None

    def loss(x, w, res):
        o, y = j_fused_add(x, res, w, 1e-5, True)
        return jnp.sum(o * g) + (jnp.sum(y * gy) if with_dres else 0.0)

    argnums = (0, 1, 2) if with_res else (0, 1)
    want = jax.grad(loss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(w), None if res is None else jnp.asarray(res))

    y = tt(x) if res is None else tt(x) + tt(res)
    dx, dy, dw = tnorms.add_norm_bwd_plain(y, tt(g), tt(w), None if gy is None else tt(gy), 1e-5)
    assert dx.dtype == torch.float32 and dy.dtype == torch.float32 and dw.shape == (d,)
    assert _rel_err(dx, want[0]) < 1e-4 and _rel_err(dw, want[1]) < 1e-4
    if with_res:
        assert _rel_err(dy, want[2]) < 1e-4

    # and through the wrapper's autograd Function, which saves (y, w) only
    leaves = [tt(x).requires_grad_(), tt(w).requires_grad_()]
    if with_res:
        leaves.append(tt(res).requires_grad_())
    o, ys = fused_add_rms_norm(leaves[0], leaves[2] if with_res else None, leaves[1], 1e-5)
    total = (o * tt(g)).sum() + ((ys * tt(gy)).sum() if with_dres else 0.0)
    got = torch.autograd.grad(total, leaves)
    for a, b in zip(got, want):
        assert _rel_err(a, b) < 1e-4


def test_add_norm_bwd_types_and_absent_outputs():
    """dx takes the cotangent's type, dw is fp32 summed over rows, and the
    wrapper leaves dy out where the forward had no residual."""
    rng = np.random.default_rng(5)
    y = tt(rng.standard_normal((7, 64)).astype(np.float32))
    g = tt(rng.standard_normal((7, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    dx, dy, dw = fused_add_rms_norm_bwd(y, g, w, None, 1e-5, with_dy=False)
    assert dx.dtype == torch.bfloat16 and dy is None and dw.dtype == torch.float32
    dx2, dy2, _ = fused_add_rms_norm_bwd(y, g, w, None, 1e-5)
    assert torch.equal(dx2, dx) and torch.equal(dy2.to(torch.bfloat16), dx)


# name: (rows-shape, d, bf16 inputs, weight dtype, columns beside z in its matrix on
# the port's side: z a column slice there, as on the model's path)
GATED_BWD_CASES = {
    "fp32": ((2, 11), 256, False, np.float32, 0),
    "bf16_d4096_z_slice": ((2, 3), 4096, True, "bfloat16", 320),
    "fp32_awkward": ((3, 5), 250, False, np.float32, 0),
    "bf16_more_rows_than_blocks": ((1200,), 252, True, "bfloat16", 0),
    "bf16_fp32_weight": ((7,), 1001, True, np.float32, 0),
}


def _per_element_ok(got, want, rtol, atol_rel):
    """|got - want| <= rtol |want| + atol_rel max|want| at every element."""
    g, w = nn(got).astype(np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(g - w) <= rtol * np.abs(w) + atol_rel * np.abs(w).max()))


@pytest.mark.parametrize("name", list(GATED_BWD_CASES))
def test_gated_norm_bwd_plain_vs_interpreted_pallas(name):
    """K6b's plain version against the VJP of
    ``norms_pallas.fused_gated_rms_norm`` in interpret mode, on the same
    values. fp32 outputs within 1e-4 of the gradient's largest value; bf16 dy
    and dz element by element within 2^-7 of the value plus 2e-5 of the largest
    (one rounding of fp32 sums taken in another order), dw (fp32 on the port's
    side) within 1e-4. JAX returns dw in the weight's type, so a bf16 weight
    goes into JAX widened to fp32 (the same values): its dw is then fp32 too."""
    lead, d, bf16, wdtype, beside = GATED_BWD_CASES[name]
    rng = np.random.default_rng(2)
    xdtype = jnp.bfloat16 if bf16 else jnp.float32
    y = jnp.asarray(rng.standard_normal((*lead, d)).astype(np.float32)).astype(xdtype)
    wide = jnp.asarray(rng.standard_normal((*lead, d + beside)).astype(np.float32)).astype(xdtype)
    g = jnp.asarray(rng.standard_normal((*lead, d)).astype(np.float32)).astype(xdtype)
    w = jnp.asarray((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)).astype(
        jnp.bfloat16 if wdtype == "bfloat16" else jnp.float32)
    z = wide[..., :d]
    want = jax.grad(lambda y, z, w: jnp.sum(j_fused_gated(y, z, w, 1e-5, True).astype(jnp.float32)
                                            * g.astype(jnp.float32)),
                    argnums=(0, 1, 2))(y, z, w.astype(jnp.float32))
    assert want[2].dtype == jnp.float32

    tz = tt(wide)[..., :d]
    assert tz.is_contiguous() == (beside == 0)
    args = (tt(y), tz, tt(g), tt(w), 1e-5)
    got = tnorms.gated_rms_norm_bwd_plain(*args)
    again = fused_gated_rms_norm_bwd(*args)
    assert got[2].dtype == torch.float32
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
        if bf16:
            assert _per_element_ok(a, b, 2.0 ** -7, 2e-5)
        else:
            assert _rel_err(a, b) < 1e-4
    assert _rel_err(got[2], want[2]) < 1e-4

    # and through the wrapper's autograd Function
    leaves = [t.clone().requires_grad_() for t in (tt(y), tz, tt(w))]
    out = fused_gated_rms_norm(*leaves, 1e-5)
    grads = torch.autograd.grad((out.float() * tt(g).float()).sum(), leaves)
    for a, b in zip(grads, got):
        assert torch.equal(a, b.to(a.dtype))


def test_gated_norm_bwd_on_a_column_slice():
    """z is a column slice of the in_proj output on the model's path."""
    rng = np.random.default_rng(6)
    wide = tt(rng.standard_normal((3, 5, 80)).astype(np.float32))
    y = tt(rng.standard_normal((3, 5, 32)).astype(np.float32))
    g = tt(rng.standard_normal((3, 5, 32)).astype(np.float32))
    w = tt((1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32))
    z = wide[..., 8:40]
    a = fused_gated_rms_norm_bwd(y, z, g, w, 1e-5)
    b = fused_gated_rms_norm_bwd(y, z.contiguous(), g, w, 1e-5)
    assert all(torch.equal(p, q) for p, q in zip(a, b))

"""ops of the PyTorch port against the JAX package, on the CPU.

Each test feeds the same numpy inputs to the JAX function and to its
counterpart in ``omnimamba_tpu_torch.ops``. Where the JAX function is a
Pallas kernel it runs in interpret mode, as the JAX package's own tests run
it; the port's kernel wrappers run their plain versions, because the tensors
lie on the CPU. No tolerance is looser than the JAX package's own test of
the same kernel against its oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu.ops import conv as jconv
from omnimamba_tpu.ops import norms as jnorms
from omnimamba_tpu.ops import sampling as jsamp
from omnimamba_tpu.ops.norms_pallas import fused_add_rms_norm as j_fused_add
from omnimamba_tpu.ops.norms_pallas import fused_gated_rms_norm as j_fused_gated
from omnimamba_tpu.ops.ssd_chunked import ssd_chunked as j_ssd_chunked
from omnimamba_tpu.ops.ssd_pallas import ssd_pallas
from omnimamba_tpu.ops.ssd_reference import ssd_scan_reference as j_ssd_ref
from omnimamba_tpu.ops.ssd_reference import ssd_step as j_ssd_step
from omnimamba_tpu.ops.ssd_step_pallas import ssd_step_pallas
from omnimamba_tpu_torch.ops import conv as tconv
from omnimamba_tpu_torch.ops import norms as tnorms
from omnimamba_tpu_torch.ops import sampling as tsamp
from omnimamba_tpu_torch.ops.norms_kernel import fused_add_rms_norm, fused_gated_rms_norm
from omnimamba_tpu_torch.ops.ssd_chunked import ssd_chunked
from omnimamba_tpu_torch.ops.ssd_kernel import PLAIN_CHUNK, ssd_fused
from omnimamba_tpu_torch.ops.ssd_reference import ssd_scan_reference, ssd_step
from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused
from tests.test_torch_helpers import nn, tt


def ssd_inputs(seed, B=2, L=32, H=4, P=8, G=2, N=16, with_state=False):
    rng = np.random.default_rng(seed)
    d = dict(
        x=rng.standard_normal((B, L, H, P)).astype(np.float32),
        dt=np.log1p(np.exp(rng.standard_normal((B, L, H)) - 1.0)).astype(np.float32),
        A=(-np.exp(rng.uniform(0.0, 1.5, (H,)))).astype(np.float32),
        Bmat=(rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32),
        Cmat=(rng.standard_normal((B, L, G, N)) / np.sqrt(N)).astype(np.float32),
        D=np.linspace(0.5, 1.5, H).astype(np.float32),
    )
    state = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_state else None
    return d, state


def both(d):
    return {k: jnp.asarray(v) for k, v in d.items()}, {k: tt(v) for k, v in d.items()}


def close(got, want, tol):
    np.testing.assert_allclose(nn(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


# fp32 on both sides, same algorithm, other summation order: 1e-5
FP32 = 1e-5


@pytest.mark.parametrize("L,G,with_state", [(1, 2, False), (37, 1, False), (32, 2, True)])
def test_ssd_scan_reference(L, G, with_state):
    d, state = ssd_inputs(0, L=L, G=G, with_state=with_state)
    j, t = both(d)
    yj, sj = j_ssd_ref(*j.values(), initial_state=None if state is None else jnp.asarray(state))
    yt, st = ssd_scan_reference(*t.values(), initial_state=None if state is None else tt(state))
    close(yt, yj, FP32)
    close(st, sj, FP32)


@pytest.mark.parametrize("L,Q,with_state", [(32, 16, False), (37, 16, False), (37, 16, True), (5, 256, True)])
def test_ssd_chunked(L, Q, with_state):
    d, state = ssd_inputs(1, L=L, with_state=with_state)
    j, t = both(d)
    yj, sj = j_ssd_chunked(*j.values(), chunk_size=Q,
                           initial_state=None if state is None else jnp.asarray(state))
    yt, st = ssd_chunked(*t.values(), chunk_size=Q,
                         initial_state=None if state is None else tt(state))
    close(yt, yj, FP32)
    close(st, sj, FP32)
    # and against the port's own sequential oracle
    yr, sr = ssd_scan_reference(*t.values(), initial_state=None if state is None else tt(state))
    close(yt, nn(yr), FP32)
    close(st, nn(sr), FP32)


SCAN_CASES = dict(
    argnames="L,Q,G,with_D,tail",
    argvalues=[(32, 8, 2, True, 0), (64, 16, 1, True, 0), (24, 16, 2, True, 0),
               (37, 8, 1, False, 0), (40, 16, 2, True, 11)],
    ids=["aligned", "G1", "ragged", "ragged_noD", "dt0_tail"],
)


@pytest.mark.parametrize(**SCAN_CASES)
def test_scan_kernel_plain_vs_pallas(L, Q, G, with_D, tail):
    """Plain version of the scan kernel (what ``ssd_fused`` runs for a CPU
    tensor) against ``ssd_pallas`` in interpret mode. 2e-4 is the tolerance of
    the JAX package's own test of that kernel against its oracle."""
    d, _ = ssd_inputs(2, L=L, G=G)
    if tail:
        d["dt"][:, -tail:] = 0.0
    if not with_D:
        d["D"] = None
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    t = {k: None if v is None else tt(v) for k, v in d.items()}
    yj, sj = ssd_pallas(*j.values(), chunk_size=Q, interpret=True)
    yt, st = ssd_fused(*t.values())
    close(yt, yj, 2e-4)
    close(st, sj, 2e-4)
    if tail:
        # dt = 0 rows are exact no-ops: the state equals the shorter run's
        _, s_short = ssd_fused(t["x"][:, :-tail], t["dt"][:, :-tail], t["A"],
                               t["Bmat"][:, :-tail], t["Cmat"][:, :-tail], t["D"])
        assert torch.equal(st, s_short)


@pytest.mark.parametrize(**SCAN_CASES)
def test_scan_kernel_plain_bf16_vs_pallas(L, Q, G, with_D, tail):
    """The plain version with bf16 x, B and C against ``ssd_pallas`` on the
    same bf16 inputs in interpret mode at the plain version's chunk of 16
    (the JAX kernel's small-chunk path, ``mxu_dtype`` bf16). Both round the
    operands of their products at the same points and sum in fp32 in another
    order, so an operand may round the other way: y within 2^-7 of itself
    (one bf16 unit of a bf16 output) + 2^-14 of the largest |y|, the fp32
    final state within 2^-14 of its largest value. Products on unrounded
    operands miss the state bound by 15-48 times on these cases."""
    d, _ = ssd_inputs(2, L=L, G=G)
    if tail:
        d["dt"][:, -tail:] = 0.0
    if not with_D:
        d["D"] = None
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    t = {k: None if v is None else tt(v) for k, v in d.items()}
    for k in ("x", "Bmat", "Cmat"):
        j[k], t[k] = j[k].astype(jnp.bfloat16), t[k].to(torch.bfloat16)
    yj, sj = ssd_pallas(*j.values(), chunk_size=16, interpret=True)
    yt, st = ssd_fused(*t.values())
    assert yt.dtype == torch.bfloat16 and st.dtype == torch.float32
    yw, sw = np.asarray(yj.astype(jnp.float32)), np.asarray(sj)
    y_allowed = 2.0 ** -7 * np.abs(yw) + 2.0 ** -14 * np.abs(yw).max()
    assert float((np.abs(nn(yt.float()) - yw) / y_allowed).max()) <= 1.0
    assert float(np.abs(nn(st) - sw).max()) <= 2.0 ** -14 * float(np.abs(sw).max())
    if tail:
        _, s_short = ssd_fused(t["x"][:, :-tail], t["dt"][:, :-tail], t["A"],
                               t["Bmat"][:, :-tail], t["Cmat"][:, :-tail], t["D"])
        assert torch.equal(st, s_short)


def test_scan_kernel_plain_fp32_is_chunked():
    """For fp32 x the plain version is ``ssd_chunked`` at its chunk, bit for
    bit: y, the final state and the chunk states."""
    d, _ = ssd_inputs(5, L=45, G=2)
    t = [tt(v) for v in d.values()]
    got = ssd_fused(*t, return_chunk_states=True)
    want = ssd_chunked(*t, chunk_size=PLAIN_CHUNK, return_chunk_states=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_scan_kernel_refuses_chunk_states():
    """Until the training slice the scan refused ``return_chunk_states``; it
    now returns the fp32 state entering every chunk of 16 tokens, which is
    what the backward kernel starts from, and refuses nothing for it. y and
    the final state do not depend on the option. (Held against the
    interpreted Pallas kernel in ``tests/test_torch_train_ops.py``.)"""
    d, _ = ssd_inputs(2, L=40)
    t = [tt(v) for v in d.values()]
    y, s, h = ssd_fused(*t, return_chunk_states=True)
    assert h.shape == (2, 3, 4, 8, 16) and h.dtype == torch.float32
    assert float(h[:, 0].abs().max()) == 0.0 and float(h[:, 1].abs().max()) > 0.0
    y2, s2 = ssd_fused(*t)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    # the state entering chunk c is the final state of the first 16 * c tokens
    _, s32 = ssd_fused(*[v[:, :32] if v.dim() > 1 else v for v in t])
    close(h[:, 2], nn(s32), FP32)


def step_inputs(seed, B, H=8, P=16, N=32, G=1, state_dtype="float32", x_dtype="bfloat16"):
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.dtype(x_dtype)).astype(jnp.float32))  # noqa: E731
    sd = lambda a: np.asarray(jnp.asarray(a, jnp.dtype(state_dtype)).astype(jnp.float32))  # noqa: E731
    return dict(
        x_t=bf(rng.normal(size=(B, H, P))),
        dt_t=np.abs(rng.normal(size=(B, H))).astype(np.float32),
        A=(-np.abs(rng.normal(size=(H,)))).astype(np.float32),
        B_t=bf(rng.normal(size=(B, G, N))),
        C_t=bf(rng.normal(size=(B, G, N))),
        D=rng.normal(size=(H,)).astype(np.float32),
        state=sd(rng.normal(size=(B, H, P, N))),
    )


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [4, 16], ids=["B4_naive_form", "B16_distributed_form"])
def test_step_kernel_plain_vs_jax(B, state_dtype):
    """Plain version of the step kernel against ``ssd_step`` (both of its
    forms: the JAX function switches at B >= 16) and against
    ``ssd_step_pallas`` in interpret mode. Tolerances are those of the JAX
    package's test of the Pallas step: 1e-3 on the state, 2e-2 on the bf16 y."""
    d = step_inputs(3, B, state_dtype=state_dtype)
    xd, sdt = jnp.bfloat16, jnp.dtype(state_dtype)
    j = dict(x_t=jnp.asarray(d["x_t"], xd), dt_t=jnp.asarray(d["dt_t"]), A=jnp.asarray(d["A"]),
             B_t=jnp.asarray(d["B_t"], xd), C_t=jnp.asarray(d["C_t"], xd), D=jnp.asarray(d["D"]),
             state=jnp.asarray(d["state"], sdt))
    t_sd = torch.float32 if state_dtype == "float32" else torch.bfloat16
    t = dict(x_t=tt(d["x_t"], torch.bfloat16), dt_t=tt(d["dt_t"]), A=tt(d["A"]),
             B_t=tt(d["B_t"], torch.bfloat16), C_t=tt(d["C_t"], torch.bfloat16), D=tt(d["D"]))
    state = tt(d["state"], t_sd)
    before = state.clone()

    y_plain, s_plain = ssd_step(**t, state=state)
    assert torch.equal(state, before), "the plain step leaves its argument alone"
    y_t, s_t = ssd_step_fused(**t, state=state)
    assert s_t is state and torch.equal(state, s_plain), "the wrapper updates the state in place"
    assert torch.equal(y_t, y_plain)
    assert y_t.dtype == torch.bfloat16 and s_t.dtype == t_sd

    for jax_fn in (j_ssd_step, lambda **kw: ssd_step_pallas(**kw, head_tile=4, interpret=True)):
        y_j, s_j = jax_fn(**j)
        s_j = np.asarray(s_j.astype(jnp.float32))
        if state_dtype == "float32":
            close(s_t, s_j, 1e-3)
        else:
            # the fp32 new state is rounded to bf16 on both sides; exp() of the
            # two frameworks may differ in the last fp32 bit, which flips the
            # rounding of a value that lies between two bf16 numbers. So: at
            # most one bf16 ulp (up to 2^-7 relative) anywhere, and all but 0.1% of
            # the elements inside the JAX test's 1e-3.
            err = np.abs(nn(s_t) - s_j)
            assert np.all(err <= 2.0 ** -7 * np.abs(s_j) + 1e-6)
            assert np.mean(err > 1e-3 + 1e-3 * np.abs(s_j)) < 1e-3
        close(y_t, np.asarray(y_j.astype(jnp.float32)), 2e-2)


def test_step_kernel_plain_fp32_groups_no_D():
    d = step_inputs(4, 3, H=8, G=2, N=16, x_dtype="float32")
    d["D"] = None
    j = {k: None if v is None else jnp.asarray(v) for k, v in d.items()}
    t = {k: None if v is None else tt(v) for k, v in d.items()}
    y_j, s_j = j_ssd_step(**j)
    y_t, s_t = ssd_step_fused(**t)
    close(y_t, y_j, FP32)
    close(s_t, s_j, FP32)


def test_step_refuses_int8_state():
    """Once refused, now taken: a scaled-int8 state {q, scale} goes through
    the plain step and the kernel wrapper (its plain version here) and comes
    back requantized, y close to the step on the dequantized fp32 state."""
    from omnimamba_tpu_torch.ops.quant import dequantize_ssm_state, quantize_ssm_state

    d = step_inputs(4, 2, x_dtype="float32")
    t = {k: tt(v) for k, v in d.items()}
    t["state"] = quantize_ssm_state(t["state"])
    y8, s8 = ssd_step(**t)
    assert s8["q"].dtype == torch.int8 and s8["scale"].shape == t["state"]["scale"].shape
    y32, s32 = ssd_step(**{**t, "state": dequantize_ssm_state(t["state"])})
    close(y8, nn(y32), FP32)
    assert torch.equal(s8["q"], quantize_ssm_state(s32)["q"])
    yk, sk = ssd_step_fused(**t)
    assert sk is t["state"] and torch.equal(sk["q"], s8["q"]) and torch.equal(yk, y8)


def _check_add_norm(shape, with_res, dtype, seed):
    """Plain version of the add+RMSNorm kernel against ``add_norm`` and the
    Pallas forward in interpret mode; tolerances of tests/test_norms_pallas.py
    (y 1e-6; out 1e-5 in fp32, 2e-2 in bf16)."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    xn = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.dtype(dtype)).astype(jnp.float32))
    rn = rng.standard_normal(shape).astype(np.float32) if with_res else None
    wn = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    xj = jnp.asarray(xn, jnp.dtype(dtype))
    rj = None if rn is None else jnp.asarray(rn)
    t_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    out_t, y_t = fused_add_rms_norm(tt(xn, t_dt), None if rn is None else tt(rn), tt(wn), 1e-5)
    out_m, y_m = tnorms.add_norm(tt(xn, t_dt), None if rn is None else tt(rn), tt(wn), 1e-5)
    assert torch.equal(out_t, out_m) and torch.equal(y_t, y_m)
    assert out_t.dtype == t_dt and y_t.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    refs = (
        jnorms.add_norm(xj, rj, jnp.asarray(wn), eps=1e-5, is_rms=True,
                        residual_in_fp32=True, prenorm=True),
        j_fused_add(xj, rj, jnp.asarray(wn), 1e-5, True),
    )
    for out_j, y_j in refs:
        close(y_t, y_j, 1e-6)
        close(out_t, np.asarray(out_j.astype(jnp.float32)), tol)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_norm_kernel_plain_vs_jax(with_res, dtype):
    _check_add_norm((2, 13, 256), with_res, dtype, 0)


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("d", [1024, 2048])
@pytest.mark.parametrize("rows", [1, 3, 48])
def test_add_norm_kernel_decode_rows_plain_vs_jax(rows, d, with_res):
    """The rows the decode-rows kernel takes on the card (bf16, d = 1024 E, at
    most 256 of them), as the layer loop gives them: (rows, d)."""
    _check_add_norm((rows, d), with_res, "bfloat16", 100 + rows + d)


def _check_gated_norm(shape, dtype, seed, beside=0):
    """Plain version of the gated RMSNorm kernel against ``gated_rms_norm`` and
    the Pallas forward in interpret mode (out 1e-5 in fp32, 2e-2 in bf16). With
    ``beside``, z is the first d columns of a matrix ``beside`` columns wider,
    as the mixer passes the in_proj output's slice."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    cast = lambda a: np.asarray(jnp.asarray(a, jnp.dtype(dtype)).astype(jnp.float32))  # noqa: E731
    yn = cast(rng.standard_normal(shape))
    zwide = cast(rng.standard_normal((*shape[:-1], d + beside)))
    zn = zwide[..., :d]
    wn = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    t_dt = torch.float32 if dtype == "float32" else torch.bfloat16
    z_t = tt(zwide, t_dt)[..., :d]
    assert z_t.stride(-2) == d + beside
    out_t = fused_gated_rms_norm(tt(yn, t_dt), z_t, tt(wn), 1e-5)
    assert torch.equal(out_t, tnorms.gated_rms_norm(tt(yn, t_dt), tt(zn, t_dt), tt(wn), 1e-5))
    yj, zj = jnp.asarray(yn, jnp.dtype(dtype)), jnp.asarray(zn, jnp.dtype(dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for out_j in (jnorms.gated_rms_norm(yj, zj, jnp.asarray(wn), 1e-5),
                  j_fused_gated(yj, zj, jnp.asarray(wn), 1e-5, True)):
        close(out_t, np.asarray(out_j.astype(jnp.float32)), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_kernel_plain_vs_jax(dtype):
    _check_gated_norm((2, 13, 256), dtype, 1)


@pytest.mark.parametrize("d", [1024, 4096])
@pytest.mark.parametrize("rows", [1, 3, 48])
def test_gated_norm_kernel_decode_rows_plain_vs_jax(rows, d):
    """The rows the decode-rows kernel takes on the card (bf16, d = 1024 E), z
    a column slice of the in_proj output (2 d + 2 N + H wide at the 1.3B)."""
    _check_gated_norm((rows, d), "bfloat16", 200 + rows + d, beside=d + 2 * 128 + 64)


def test_rms_norm():
    rng = np.random.default_rng(2)
    x, w = rng.standard_normal((3, 5, 64)).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    close(tnorms.rms_norm(tt(x), tt(w), 1e-5), jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), FP32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("activation", ["silu", None])
def test_causal_conv1d(with_state, activation):
    rng = np.random.default_rng(3)
    B, L, C, W = 2, 9, 12, 4
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    s = rng.standard_normal((B, W - 1, C)).astype(np.float32) if with_state else None
    yj = jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), activation=activation,
                             initial_state=None if s is None else jnp.asarray(s))
    yt = tconv.causal_conv1d(tt(x), tt(w), tt(b), activation=activation,
                             initial_state=None if s is None else tt(s))
    close(yt, yj, FP32)


@pytest.mark.parametrize("L", [1, 2, 9])
def test_conv_state_from_sequence(L):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, L, 6)).astype(np.float32)
    s = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for init in (None, s):
        sj = jconv.conv_state_from_sequence(jnp.asarray(x), 4, None if init is None else jnp.asarray(init))
        st = tconv.conv_state_from_sequence(tt(x), 4, None if init is None else tt(init))
        np.testing.assert_array_equal(nn(st), np.asarray(sj))


def test_causal_conv1d_step_continues_the_sequence():
    rng = np.random.default_rng(5)
    B, L, C, W = 2, 7, 10, 4
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    s = rng.standard_normal((B, W - 1, C)).astype(np.float32)
    yj, sj = jconv.causal_conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(s), jnp.asarray(w), jnp.asarray(b))
    yt, st = tconv.causal_conv1d_step(tt(x[:, 0]), tt(s), tt(w), tt(b))
    close(yt, yj, FP32)
    np.testing.assert_array_equal(nn(st), np.asarray(sj))
    # stepping token by token equals the full-sequence conv
    full = tconv.causal_conv1d(tt(x), tt(w), tt(b))
    state = torch.zeros(B, W - 1, C)
    for t in range(L):
        y_t, state = tconv.causal_conv1d_step(tt(x[:, t]), state, tt(w), tt(b))
        close(y_t, nn(full[:, t]), FP32)


def _logits(seed, B=4, V=50):
    return (3.0 * np.random.default_rng(seed).standard_normal((B, V))).astype(np.float32)


@pytest.mark.parametrize(
    "name,arg", [("apply_top_k", 5), ("apply_top_k", 0), ("apply_top_k", 500),
                 ("apply_top_p", 0.8), ("apply_top_p", 0.0), ("apply_top_p", 0.3),
                 ("apply_min_p", 0.1), ("apply_min_p", 0.0), ("apply_min_p", 0.6)])
def test_sampling_filters_equal(name, arg):
    """The filters keep exactly the same tokens and leave their logits alone."""
    lg = _logits(6)
    out_j = np.asarray(getattr(jsamp, name)(jnp.asarray(lg), arg))
    out_t = nn(getattr(tsamp, name)(tt(lg), arg))
    np.testing.assert_array_equal(np.isneginf(out_t), np.isneginf(out_j))
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("penalty", [1.3, 0.7, 1.0])
@pytest.mark.parametrize("with_mask", [False, True])
def test_repetition_penalty_equal(penalty, with_mask):
    rng = np.random.default_rng(7)
    lg = _logits(7, B=3, V=20)
    prev = rng.integers(0, 20, (3, 9))
    prev[:, 3] = prev[:, 0]  # duplicates are benign
    mask = (rng.random((3, 9)) < 0.6) if with_mask else None
    out_j = jsamp.apply_repetition_penalty(
        jnp.asarray(lg), jnp.asarray(prev), penalty, None if mask is None else jnp.asarray(mask))
    out_t = tsamp.apply_repetition_penalty(
        tt(lg), tt(prev), penalty, None if mask is None else tt(mask))
    np.testing.assert_allclose(nn(out_t), np.asarray(out_j), rtol=1e-6, atol=0)


def test_sample_token_greedy_equal():
    lg = _logits(8)
    p = dict(top_k=1)
    tok_j = jsamp.sample_token(jax.random.PRNGKey(0), jnp.asarray(lg), jsamp.SampleParams(**p))
    tok_t = tsamp.sample_token(None, tt(lg), tsamp.SampleParams(**p))
    np.testing.assert_array_equal(nn(tok_t), np.asarray(tok_j))


@pytest.mark.parametrize(
    "params", [dict(top_k=5, temperature=0.8, top_p=0.9), dict(top_k=0, min_p=0.2, temperature=1.3),
               dict(top_k=0, top_p=0.7, temperature=0.9)],
    ids=["top_k", "min_p", "top_p"])
def test_sample_token_distribution(params):
    """A torch.Generator and a JAX key give other draws from one seed, so the
    draw is held in distribution: frequencies of 20000 draws against the
    probabilities of the JAX-filtered logits, within 5 standard errors, and no
    draw outside the JAX filter's support."""
    V, n = 12, 20000
    lg = _logits(9, B=1, V=V)
    sp = jsamp.SampleParams(**params)
    x = jnp.asarray(lg)
    if sp.top_k > 0:
        f = jsamp.apply_top_p(jsamp.apply_top_k(x, sp.top_k) / sp.temperature, sp.top_p)
    elif sp.min_p > 0:
        f = jsamp.apply_min_p(x, sp.min_p) / sp.temperature
    else:
        f = jsamp.apply_top_p(x / sp.temperature, sp.top_p)
    probs = np.asarray(jax.nn.softmax(f, axis=-1))[0]
    gen = torch.Generator().manual_seed(0)
    draws = nn(tsamp.sample_token(gen, tt(np.repeat(lg, n, axis=0)), tsamp.SampleParams(**params)))
    freq = np.bincount(draws, minlength=V) / n
    assert np.all(freq[probs == 0] == 0)
    se = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) <= 5 * se + 1e-9), (freq, probs)

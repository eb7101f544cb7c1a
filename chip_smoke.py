"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

builds the port's CUDA kernels from the sources in this checkout, holds each
of the nine kernels (and the int8 branches of the decode-step kernels)
against its plain PyTorch version on the card, and drives the port's main
paths at the full 1.3B width and depth with random weights made from a seed:

- greedy text-to-image generation at batch 48 through both decode paths (the
  whole-model decode kernel and the layer-by-layer step), then a kernel run
  of the decode engine against a plain-version run end to end;
- int8 serving: the same generation on `quantize_decode_params` of the bf16
  weights through both paths (the layer-by-layer one with the scaled-int8
  state), the continuous-batching slot engine on 64 requests, and
  speculative decoding with three drafts against plain greedy decoding;
- stage-1 text-to-image training: the loss and every gradient through the
  kernels against the same through the plain versions (3 layers, fp32), then
  `Trainer.train(max_steps=3)` at batch 90 in bf16 (halved until it fits),
  the split of a step, one profiled step, and the memory peaks behind the
  rule that resolves remat="proj".

The launch counters show that each path went through its kernels. Any failed
phase ends the run with a non-zero exit code; nothing is caught but the
out-of-memory error that halves the training batch. Without a CUDA device it
exits with code 2 and prints no result.

Lines on standard output, one JSON object each unless noted:
  the card as `nvidia-smi --query-gpu=name,power.limit` gives it (plain text),
  {"card": ...} {"build": ...} {"kernel_check": ...}* {"qmatmul_m_sweep": ...} {"main_path": ...}
  {"decode_profile": ...} {"times": ...} {"fidelity": ...} {"int8_path": ...} {"slot_engine": ...}
  {"speculative": ...} {"plain_vs_kernel": ...}*
  {"train_plain_vs_kernel": ...} {"train_path": ...} {"train_times": ...}
  {"remat_threshold": ...} {"kernels": [...]} and, last,
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

fp32 comparisons run with TF32 off for matrix products and convolutions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

# published peaks of one H100 SXM (dense): device memory bytes/s, and
# operations/s for bf16 tensor-core and for fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

SEED = 0
BATCH = 48  # main path: serving batch of the 1.3B text-to-image workload
PROMPT = 72  # caption block length
TRAIN_BATCH = 90  # stage-1 T2I training: batch_size_t2i of config/config_stage1_t2i.yaml
TRAIN_LEN = PROMPT + 256  # caption block + image tokens


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


_BLOCKER = {}


def _occupy_device(ms: float) -> None:
    """Enqueue about `ms` milliseconds of matrix products. While the device
    works them off, the host runs ahead and queues what follows, so the
    launches that are timed next start back to back and their time on the
    device is read free of the host's time to enqueue them."""
    if not _BLOCKER:
        a = torch.zeros((8192, 8192), device="cuda", dtype=torch.bfloat16)
        torch.mm(a, a)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.mm(a, a)
        end.record()
        torch.cuda.synchronize()
        _BLOCKER.update(a=a, ms=start.elapsed_time(end))
    for _ in range(int(ms / _BLOCKER["ms"]) + 1):
        torch.mm(_BLOCKER["a"], _BLOCKER["a"])


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds on the device of one call: CUDA events around `iters`
    calls that were queued behind other work (see `_occupy_device`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3  # time to enqueue one call
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _occupy_device(2.0 * host_ms * iters + 1.0)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_alone_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median milliseconds on the device of one call with nothing beside it:
    CUDA events around each of `iters` calls, queued behind other work (see
    `_occupy_device`), each call behind an ordinary one-element kernel, so
    that no call starts while the one before it runs (as a programmatic
    dependent launch of a kernel after its own kind may)."""
    pad = torch.zeros(1, device="cuda")

    def one():
        pad.add_(1.0)
        fn()

    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    host_ms = (time.perf_counter() - t0) * 1e3  # time to enqueue one call
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    _occupy_device(2.0 * host_ms * iters + 1.0)
    for start, end in events:
        pad.add_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def host_clock_ms(fn, iters: int) -> float:
    """Mean milliseconds of one call on the host's clock, enqueueing and device
    work together: `iters` calls, then a device synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def host_us(fn, iters: int = 200) -> float:
    """Mean microseconds the host spends to enqueue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def errors(got, want, atol_rel=None, rtol=None):
    """(max abs error, worst share of the allowed error), element by element.

    Allowed at an element: rtol * |reference| + atol_rel * max|reference|,
    rtol = RTOL[dtype] and atol_rel = ATOL_REL unless the caller states others.
    Kernel and plain version do the same fp32 arithmetic in another summation
    order, which ATOL_REL covers; a bf16 output may besides round a value that
    lies between two bf16 numbers the other way, one unit in the last place,
    which is at most 2^-7 of the value itself."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError("kernel output is not finite")
    err = (g - w).abs()
    atol_rel = ATOL_REL if atol_rel is None else atol_rel
    rtol = RTOL[got.dtype] if rtol is None else rtol
    allowed = rtol * w.abs() + atol_rel * max(w.abs().max().item(), 1e-30)
    return err.max().item(), (err / allowed).max().item()


def rand(gen, shape, dtype, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)).to(dtype)


# ---------------------------------------------------------------------------
# phase: each kernel against its plain version
# ---------------------------------------------------------------------------
# Tolerances: see `errors`. Every output element is held on its own.
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
ATOL_REL = 2e-5


def sliced(gen, lead, widths, dtype, scales=None):
    """Column slices of one random matrix (*lead, sum(widths)): the layout in
    which the mixer hands x | B | C (slices of the conv output) and z (a slice
    of the in_proj output) to the kernels. Nothing is copied."""
    scales = scales or [1.0] * len(widths)
    fused = torch.cat([rand(gen, (*lead, w), dtype, sc) for w, sc in zip(widths, scales)], dim=-1)
    return torch.split(fused, list(widths), dim=-1)


def ssd_inputs(gen, B, L, H, P, G, N, dtype, fused=True):
    """Inputs of the scan. With `fused`, x, Bm and Cm are views into one
    (B, L, H*P + 2*G*N) tensor, as on the main path; else each is contiguous."""
    xs, Bs, Cs = sliced(gen, (B, L), (H * P, G * N, G * N), dtype, (1.0, 0.5, 0.5))
    x, Bm, Cm = xs.view(B, L, H, P), Bs.view(B, L, G, N), Cs.view(B, L, G, N)
    if not fused:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = F.softplus(rand(gen, (B, L, H), torch.float32) - 2.0)
    A = -torch.exp(rand(gen, (H,), torch.float32, 0.5))
    D = rand(gen, (H,), torch.float32)
    return x, dt, A, Bm, Cm, D


def scan_flops(B, L, H, P, N, Q):
    """Multiply-adds (x2) of the chunked algorithm with chunk Q."""
    tri = Q * (Q + 1) / 2
    per_chunk = 2 * N * tri + 2 * P * tri + 4 * Q * P * N
    return B * H * (L / Q) * per_chunk


# K1's and K5's bf16 outputs against their plain versions, which round the
# operands of their products where the kernels do (all follow the JAX
# kernels); the sums are fp32 in another order, so an operand may round the
# other way: the rule of bf16 activations at one layer (K4, `DEEP_TOL_REL`'s
# one-layer sibling), for every output, the fp32 ones too.
BWD_BF16_ATOL_REL = 2.0 ** -10
# ... and both against the fp32-operand result of the same inputs: the JAX
# package's own bound for its bf16 backward (tests/test_ssd_pallas_bwd.py)
BWD_BF16_VS_FP32_REL = 6e-2


def _vs_fp32_rel(got, exact):
    """max |got - exact| over max |exact|."""
    e = exact.float()
    return (got.float() - e).abs().max().item() / max(e.abs().max().item(), 1e-30)


def check_ssd_scan(gen, results):
    """K1 against its plain version at the main path's prefill and training
    shapes, at awkward shapes, at each tile shape of the bf16 tensor-core
    kernel and beyond them (the multiply-add kernel); bf16 cases also against
    the plain version on fp32 operands."""
    from omnimamba_tpu_torch.ops import kernel_build
    from omnimamba_tpu_torch.ops.ssd_kernel import PLAIN_CHUNK, ssd_fused, ssd_fused_plain

    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, (B, L, H, P, G, N), dtype, dt=0 tail, with D, timed, fused slices
        ("main", (BATCH, PROMPT, 64, 64, 1, 128), bf, 0, True, True, True),
        ("main_fp32", (4, PROMPT, 64, 64, 1, 128), f32, 0, True, False, True),
        ("awkward", (3, 37, 6, 24, 2, 20), f32, 0, True, False, False),
        ("awkward_bf16_tail", (3, 37, 6, 24, 2, 20), bf, 9, False, False, True),
        ("shorter_than_a_chunk", (1, 5, 4, 8, 1, 16), f32, 0, True, False, False),
        # the tensor-core kernel's other tile shapes (P, N) <= (128, 128) and (64, 256),
        # full and zero-padded
        ("head_dim_128_bf16", (2, 45, 4, 128, 1, 128), bf, 0, True, False, True),
        ("d_state_256_bf16", (2, 45, 4, 64, 1, 256), bf, 0, True, False, True),
        ("d_state_200_bf16_tail", (1, 37, 4, 40, 2, 200), bf, 5, False, False, False),
        # beyond the tiles: the multiply-add kernel, rounding at the same points
        ("beyond_tiles_128_256_bf16", (2, 37, 4, 128, 1, 256), bf, 7, True, False, True),
        ("beyond_tiles_256_128_bf16", (2, 37, 2, 256, 1, 128), bf, 0, True, False, False),
        # one layer of the training step, chunk states on
        ("train", (TRAIN_BATCH, TRAIN_LEN, 64, 64, 1, 128), bf, 0, True, True, True),
    ]
    for name, shape, dtype, tail, with_d, timed, fused in cases:
        x, dt, A, Bm, Cm, D = ssd_inputs(gen, *shape, dtype, fused)
        assert x.is_contiguous() != fused
        if tail:
            dt[:, -tail:] = 0.0
        if not with_d:
            D = None
        y, s = ssd_fused(x, dt, A, Bm, Cm, D)
        torch.cuda.synchronize()
        y_again, s_again = ssd_fused(x, dt, A, Bm, Cm, D)
        # fixed summation order: the same inputs give the same bits
        assert torch.equal(y_again, y) and torch.equal(s_again, s), (name, "two runs differ")
        del y_again, s_again
        y_ref, s_ref, h_ref = ssd_fused_plain(x, dt, A, Bm, Cm, D, return_chunk_states=True)
        # bf16 inputs: every output, the fp32 states too, by the bf16 rule
        rtol, atol_rel = (RTOL[bf], BWD_BF16_ATOL_REL) if dtype == bf else (None, ATOL_REL)
        ey, ry = errors(y, y_ref, atol_rel, rtol)
        es, rs = errors(s, s_ref, atol_rel, rtol)
        # the same launch with the states entering each chunk written out
        y2, s2, h = ssd_fused(x, dt, A, Bm, Cm, D, return_chunk_states=True)
        torch.cuda.synchronize()
        assert torch.equal(y2, y) and torch.equal(s2, s), "chunk states must not change y or the state"
        eh, rh = errors(h, h_ref, atol_rel, rtol)
        rec = {"kernel": "ssd_scan", "case": name, "shape": shape, "dtype": str(dtype),
               "path": ("tensor cores" if dtype == bf and
                        kernel_build.load_kernels().omt_ssd_scan_bf16_smem_bytes(shape[3], shape[5])
                        else "multiply-adds"),
               "inputs": "slices of one fused tensor" if fused else "contiguous",
               "y_abs_err": ey, "y_err_of_allowed": ry, "state_abs_err": es,
               "state_err_of_allowed": rs, "chunk_states_shape": list(h.shape),
               "chunk_states_abs_err": eh, "chunk_states_err_of_allowed": rh,
               "rtol": RTOL[bf] if dtype == bf else [RTOL[dtype], 0.0], "atol_rel": atol_rel,
               "same_bits_on_a_second_run": True}
        if dtype == bf:
            # the same inputs on fp32 operands (bf16 to fp32 is exact)
            exact = ssd_fused_plain(x.float(), dt, A, Bm.float(), Cm.float(), D,
                                    return_chunk_states=True)
            rec["vs_fp32_operands_rel_bound"] = BWD_BF16_VS_FP32_REL
            for key, got, want, e in zip(("y", "state", "chunk_states"), (y, s, h),
                                         (y_ref, s_ref, h_ref), exact):
                rec[f"{key}_kernel_vs_fp32_rel"] = _vs_fp32_rel(got, e)
                rec[f"{key}_plain_vs_fp32_rel"] = _vs_fp32_rel(want, e)
            del exact
        del y2, s2, h_ref
        if tail:
            # dt = 0 must leave the state exactly where the shorter sequence left it
            L = shape[1] - tail
            _, s_short = ssd_fused(x[:, :L], dt[:, :L], A, Bm[:, :L], Cm[:, :L], D)
            rec["tail_state_equal"] = bool(torch.equal(s, s_short))
            assert rec["tail_state_equal"], rec
        assert ry <= 1.0 and rs <= 1.0 and rh <= 1.0, rec
        if dtype == bf:
            assert all(rec[f"{k}_{who}_vs_fp32_rel"] <= BWD_BF16_VS_FP32_REL
                       for k in ("y", "state", "chunk_states") for who in ("kernel", "plain")), rec
        if timed:
            B, L, H, P, G, N = shape
            train = name == "train"
            # The chunk-entry states are left out of the bound: how many of them
            # are kept is the kernel's own choice, not work the function sets.
            moved = nbytes(x, dt, A, Bm, Cm, D, y, s)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = scan_flops(B, L, H, P, N, PLAIN_CHUNK) / PEAK_OPS[dtype] * 1e3

            def kernel():
                ssd_fused(x, dt, A, Bm, Cm, D, return_chunk_states=train)

            rec.update(
                ms=time_ms(kernel, 5 if train else 20),
                ms_median_of_5_launches=statistics.median(time_ms(kernel, 1, 1) for _ in range(5)),
                host_us=host_us(kernel, 20),
                plain_ms=time_ms(lambda: ssd_fused_plain(x, dt, A, Bm, Cm, D), 3, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, library_ms=None,
                ptxas=ptxas_of(results.get("build_log", ""), "ssd_scan_bf16_kernel"),
                sass=sass_counts(kernel_build.build_kernels().library, "ssd_scan_bf16_kernel",
                                 ("HMMA", "LDSM", "LDGSTS")),
                dynamic_smem_bytes=kernel_build.load_kernels().omt_ssd_scan_bf16_smem_bytes(P, N),
            )
            if train:
                states = nbytes(h)
                # the states written once besides: the floor of a forward that
                # saves every chunk's entering state in fp32
                rec.update(ms_without_chunk_states=time_ms(lambda: ssd_fused(x, dt, A, Bm, Cm, D), 5),
                           chunk_states_bytes=states,
                           bound_with_states_ms=max((moved + states) / HBM_BYTES_PER_S * 1e3, ops_ms))
                results["ssd_scan"]["train"] = {k: rec[k] for k in (
                    "shape", "ms", "ms_median_of_5_launches", "ms_without_chunk_states", "plain_ms",
                    "bound_ms", "bound_with_states_ms", "bytes_moved", "chunk_states_bytes")}
            else:
                results["ssd_scan"] = dict(rec, max_abs_err=max(ey, es, eh))
        del h
        emit({"kernel_check": rec})


def ptxas_of(log: str, kernel: str):
    """The `ptxas -v` lines (registers, spills, shared memory) of each kernel whose
    mangled name holds `kernel`, by name."""
    lines, found = log.splitlines(), {}
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            found[ln.split("'")[1]] = [x.strip() for x in lines[i + 1:i + 4]
                                       if "spill" in x or "registers" in x or "smem" in x]
    return found or None


def sass_counts(library, kernel: str, ops=("HMMA",)):
    """How often each of `ops` occurs in the SASS of the kernels whose mangled
    names hold `kernel` (`cuobjdump -sass` of the built library), by name."""
    from pathlib import Path

    from omnimamba_tpu_torch.ops import kernel_build

    cuobjdump = str(Path(kernel_build._find_nvcc()).parent / "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in dump.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
        elif name and kernel in name:
            for op in ops:
                if f" {op}." in ln or f" {op} " in ln:
                    counts.setdefault(name, dict.fromkeys(ops, 0))[op] += 1
    return counts


def check_ssd_scan_bwd(gen, results):
    """K5 against its plain version: all six gradients, at one layer of the
    training step, at awkward shapes, at each tile shape of the bf16
    tensor-core kernel and beyond them (the multiply-add kernel). bf16 cases
    are also held against the plain version on fp32 operands."""
    from omnimamba_tpu_torch.ops.ssd_kernel import (
        PLAIN_CHUNK, ssd_bwd_plain, ssd_fused, ssd_fused_bwd)

    bf, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, (B, L, H, P, G, N), dtype, with D, with gstate, timed, fused slices
        ("train", (TRAIN_BATCH, TRAIN_LEN, 64, 64, 1, 128), bf, True, False, True, True),
        ("train_fp32_gstate", (4, TRAIN_LEN, 64, 64, 1, 128), f32, True, True, False, True),
        ("awkward", (3, 37, 6, 24, 2, 20), f32, True, True, False, False),
        ("awkward_bf16_no_D", (3, 37, 6, 24, 2, 20), bf, False, False, False, True),
        ("shorter_than_a_chunk", (1, 5, 4, 8, 1, 16), f32, True, False, False, False),
        ("one_row_two_groups", (1, 48, 8, 16, 2, 32), bf, True, True, False, True),
        # the bf16 kernel's other tile shapes (P, N) <= (128, 128) and (64, 256), full and padded
        ("head_dim_128_bf16", (2, 45, 4, 128, 1, 128), bf, True, True, False, True),
        ("head_dim_96_bf16", (2, 37, 4, 96, 2, 128), bf, True, False, False, False),
        ("d_state_256_bf16", (2, 45, 4, 64, 1, 256), bf, True, True, False, True),
        ("d_state_200_bf16", (1, 37, 4, 40, 2, 200), bf, False, True, False, False),
        # beyond those tiles: the multiply-add kernel, rounding at the same points
        ("beyond_tiles_128_256_bf16", (1, 37, 4, 128, 1, 256), bf, True, True, False, True),
        ("beyond_tiles_256_128_bf16", (1, 37, 2, 256, 1, 128), bf, True, False, False, False),
    ]
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    for name, shape, dtype, with_d, with_gs, timed, fused in cases:
        B, L, H, P, G, N = shape
        x, dt, A, Bm, Cm, D = ssd_inputs(gen, *shape, dtype, fused)
        if not with_d:
            D = None
        # the cotangent of y arrives as a reshape of the gated norm's dy: contiguous
        # on the model's path; one case hands it over as a column slice too
        gy = rand(gen, (B, L, H, P), dtype)
        if name == "awkward_bf16_no_D":
            gy = sliced(gen, (B, L), (H * P, 8), dtype)[0].view(B, L, H, P)
            assert not gy.is_contiguous()
        gstate = rand(gen, (B, H, P, N), f32) if with_gs else None
        _, _, hin = ssd_fused(x, dt, A, Bm, Cm, D, return_chunk_states=True)
        got = ssd_fused_bwd(x, dt, A, Bm, Cm, D, hin, gy, gstate)
        torch.cuda.synchronize()
        again = ssd_fused_bwd(x, dt, A, Bm, Cm, D, hin, gy, gstate)
        want = ssd_bwd_plain(x, dt, A, Bm, Cm, D, hin, gy, gstate)
        # bf16 inputs: every gradient, fp32 ones too, by the bf16 rule
        rtol, atol_rel = (RTOL[bf], BWD_BF16_ATOL_REL) if dtype == bf else (None, ATOL_REL)
        rec = {"kernel": "ssd_scan_bwd", "case": name, "shape": shape, "dtype": str(dtype),
               "D": with_d, "gstate": with_gs,
               "inputs": "slices of one fused tensor" if fused else "contiguous",
               "rtol": RTOL[bf] if dtype == bf else {"fp32": 0.0, "bf16": RTOL[bf]},
               "atol_rel": atol_rel}
        if dtype == bf:
            # the same inputs on fp32 operands (bf16 to fp32 is exact)
            exact = ssd_bwd_plain(x.float(), dt, A, Bm.float(), Cm.float(), D, hin, gy.float(),
                                  gstate)
            rec["vs_fp32_operands_rel_bound"] = BWD_BF16_VS_FP32_REL
        worst = 0.0
        for i, (key, g, g2, w) in enumerate(zip(names, got, again, want)):
            if w is None:
                assert g is None, key
                continue
            assert g.dtype == w.dtype and g.shape == w.shape, key
            abs_err, share = errors(g, w, atol_rel, rtol)
            rec[f"{key}_abs_err"], rec[f"{key}_err_of_allowed"] = abs_err, share
            rec[f"{key}_max"] = w.float().abs().max().item()
            worst = max(worst, abs_err)
            # fixed summation order: the same inputs give the same bits
            assert torch.equal(g, g2), (name, key, "two runs differ")
            if dtype == bf:
                rec[f"{key}_kernel_vs_fp32_rel"] = _vs_fp32_rel(g, exact[i])
                rec[f"{key}_plain_vs_fp32_rel"] = _vs_fp32_rel(w, exact[i])
        rec["same_bits_on_a_second_run"] = True
        assert all(rec.get(f"{k}_err_of_allowed", 0.0) <= 1.0 for k in names), rec
        if dtype == bf:
            assert all(rec.get(f"{k}_{who}_vs_fp32_rel", 0.0) <= BWD_BF16_VS_FP32_REL
                       for k in names for who in ("kernel", "plain")), rec
            del exact
        if timed:
            dx, ddt, dA, dB, dC, dD = got
            # the saved chunk-entry states are left out of the bound, as in
            # check_ssd_scan: their number is the port's choice (chunk_states_bytes)
            moved = nbytes(x, dt, A, Bm, Cm, D, gy, gstate, dx, ddt, dA, dB, dC, dD)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            flops = scan_bwd_flops(B, L, H, P, N, PLAIN_CHUNK)
            ops_ms = flops / PEAK_OPS[dtype] * 1e3
            def kernel():
                ssd_fused_bwd(x, dt, A, Bm, Cm, D, hin, gy, gstate)

            states_ms = (moved + nbytes(hin)) / HBM_BYTES_PER_S * 1e3
            rec.update(
                ms=time_ms(kernel, 5),
                ms_median_of_5_launches=statistics.median(time_ms(kernel, 1, 1) for _ in range(5)),
                host_us=host_us(kernel, 10),
                plain_ms=time_ms(lambda: ssd_bwd_plain(x, dt, A, Bm, Cm, D, hin, gy, gstate), 2, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                # the saved states read once besides: the floor of a backward
                # that starts each chunk from a saved fp32 state
                bound_with_states_ms=max(states_ms, ops_ms),
                bytes_moved=moved, flops=flops, chunk_states_bytes=nbytes(hin),
                library_ms=None,
                ptxas=ptxas_of(results.get("build_log", ""),
                               "ssd_scan_bwd_bf16" if dtype == bf else "ssd_scan_bwd_kernel"),
            )
            if dtype == bf:
                from omnimamba_tpu_torch.ops import kernel_build

                rec["dynamic_smem_bytes"] = kernel_build.load_kernels().omt_ssd_scan_bwd_bf16_smem_bytes(P, N)
                rec["sass"] = sass_counts(kernel_build.build_kernels().library, "ssd_scan_bwd_bf16",
                                          ("HMMA", "LDSM", "LDGSTS"))
            results["ssd_scan_bwd"] = dict(rec, max_abs_err=worst)
        del hin, got, again, want
        emit({"kernel_check": rec})


def scan_bwd_flops(B, L, H, P, N, Q):
    """Multiply-adds (x2) of the chunked backward with chunk Q."""
    tri = Q * (Q + 1) / 2
    per_chunk = 2 * (tri * (N + P)          # M1, M2
                     + 2 * tri * N + tri * P  # the intra-chunk parts of dC, dB, K
                     + 4 * Q * P * N          # g h_in, x adj, adj B, the adjoint update
                     + P * N)                 # <h_in, adj>
    return B * H * (L / Q) * per_chunk


def check_ssd_step(gen, results):
    from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused, ssd_step_plain

    cases = [
        # name, (B, H, P, G, N), x dtype, state dtype, with D, timed, fused slices
        ("main", (BATCH, 64, 64, 1, 128), torch.bfloat16, torch.bfloat16, True, True, True),
        ("main_fp32_state", (BATCH, 64, 64, 1, 128), torch.bfloat16, torch.float32, True, True, True),
        ("awkward", (3, 6, 24, 2, 20), torch.float32, torch.float32, True, False, False),
        ("awkward_bf16_state", (3, 6, 24, 2, 20), torch.float32, torch.bfloat16, False, False, True),
    ]
    for name, (B, H, P, G, N), dtype, sdtype, with_d, timed, fused in cases:
        x, dt, A, Bm, Cm, D = ssd_inputs(gen, B, 1, H, P, G, N, dtype, fused)
        x, dt, Bm, Cm = x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0]
        assert x.is_contiguous() != fused
        if not with_d:
            D = None
        state0 = rand(gen, (B, H, P, N), sdtype)
        y_ref, s_ref = ssd_step_plain(x, dt, A, Bm, Cm, D, state0)
        state = state0.clone()
        y, s = ssd_step_fused(x, dt, A, Bm, Cm, D, state)
        torch.cuda.synchronize()
        assert s.data_ptr() == state.data_ptr(), "the state must be updated in place"
        ey, ry = errors(y, y_ref)
        es, rs = errors(s, s_ref)
        rec = {"kernel": "ssd_step", "case": name, "shape": (B, H, P, G, N),
               "dtype": str(dtype), "state_dtype": str(sdtype),
               "inputs": "slices of one fused tensor" if fused else "contiguous",
               "y_abs_err": ey, "y_err_of_allowed": ry, "state_abs_err": es,
               "state_err_of_allowed": rs, "rtol": [RTOL[dtype], RTOL[sdtype]],
               "atol_rel": ATOL_REL}
        assert ry <= 1.0 and rs <= 1.0, rec
        if timed:
            moved = nbytes(x, dt, A, Bm, Cm, D, y) + 2 * nbytes(state)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 5 * B * H * P * N / PEAK_OPS[torch.float32] * 1e3
            rec.update(
                ms=time_ms(lambda: ssd_step_fused(x, dt, A, Bm, Cm, D, state), 50),
                host_us=host_us(lambda: ssd_step_fused(x, dt, A, Bm, Cm, D, state)),
                plain_ms=time_ms(lambda: ssd_step_plain(x, dt, A, Bm, Cm, D, state), 10),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, library_ms=None,
            )
            if name == "main":
                results["ssd_step"] = dict(rec, max_abs_err=max(ey, es))
            else:
                results["ssd_step"]["fp32_state"] = {
                    k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bytes_moved")}
        emit({"kernel_check": rec})


def check_norms(gen, results):
    from omnimamba_tpu_torch.ops.norms import add_norm_plain, gated_rms_norm_plain
    from omnimamba_tpu_torch.ops.norms_kernel import fused_add_rms_norm, fused_gated_rms_norm

    # name, rows-shape, d, x dtype, weight dtype, residual, timed
    add_cases = [
        ("decode", (BATCH,), 2048, torch.bfloat16, torch.bfloat16, True, True),
        ("prefill", (BATCH, PROMPT), 2048, torch.bfloat16, torch.bfloat16, True, True),
        ("train", (TRAIN_BATCH, TRAIN_LEN), 2048, torch.bfloat16, torch.bfloat16, True, True),
        ("no_residual", (BATCH, PROMPT), 2048, torch.bfloat16, torch.bfloat16, False, False),
        ("fp32", (5, 7), 2048, torch.float32, torch.float32, True, False),
        ("awkward", (3, 5), 250, torch.float32, torch.bfloat16, False, False),
        ("awkward_bf16", (7,), 1001, torch.bfloat16, torch.float32, True, False),
    ]
    for name, lead, d, dtype, wdtype, with_res, timed in add_cases:
        x = rand(gen, (*lead, d), dtype)
        res = rand(gen, (*lead, d), torch.float32) if with_res else None
        w = (1.0 + 0.1 * rand(gen, (d,), torch.float32)).to(wdtype)
        out, y = fused_add_rms_norm(x, res, w, 1e-5)
        torch.cuda.synchronize()
        out_ref, y_ref = add_norm_plain(x, res, w, 1e-5)
        eo, ro = errors(out, out_ref)
        ey, _ = errors(y, y_ref)
        rec = {"kernel": "add_rms_norm", "case": name, "shape": (*lead, d), "dtype": str(dtype),
               "out_abs_err": eo, "out_err_of_allowed": ro, "y_abs_err": ey,
               "rtol": RTOL[dtype], "atol_rel": ATOL_REL}
        assert ro <= 1.0 and ey == 0.0, rec  # y = x + residual is one exact fp32 add
        if timed:
            moved = nbytes(x, res, w, out, y)
            rows = x.numel() // d
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 6 * rows * d / PEAK_OPS[torch.float32] * 1e3
            summed = y_ref.to(dtype)
            rec.update(
                ms=time_ms(lambda: fused_add_rms_norm(x, res, w, 1e-5), 100),
                host_us=host_us(lambda: fused_add_rms_norm(x, res, w, 1e-5)),
                plain_ms=time_ms(lambda: add_norm_plain(x, res, w, 1e-5), 20),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved,
                # F.rms_norm computes the norm half only (no residual add, no fp32 stream out)
                library_ms=time_ms(lambda: F.rms_norm(summed, (d,), w, 1e-5), 100)
                if hasattr(F, "rms_norm") else None,
            )
            rec["kernel_name"] = norm_kernel_names(lambda: fused_add_rms_norm(x, res, w, 1e-5))
            if name == "decode":
                results["add_rms_norm"] = dict(rec, max_abs_err=max(eo, ey))
            else:
                results["add_rms_norm"][name] = {k: rec[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bytes_moved", "library_ms", "kernel_name")}
        emit({"kernel_check": rec})

    # name, rows-shape, d, x dtype, weight dtype, timed, columns beside z in its matrix.
    # On the main path z is the first d_inner columns of the in_proj output
    # (2*4096 + 2*128 + 64 wide) and y is the scan's contiguous output.
    gated_cases = [
        ("decode", (BATCH,), 4096, torch.bfloat16, torch.bfloat16, True, 4096 + 256 + 64),
        ("prefill", (BATCH, PROMPT), 4096, torch.bfloat16, torch.bfloat16, True, 4096 + 256 + 64),
        ("train", (TRAIN_BATCH, TRAIN_LEN), 4096, torch.bfloat16, torch.bfloat16, True,
         4096 + 256 + 64),
        ("fp32", (5, 7), 4096, torch.float32, torch.float32, False, 4096 + 256 + 64),
        ("awkward", (3, 5), 250, torch.float32, torch.bfloat16, False, 0),
        ("awkward_bf16", (7,), 1001, torch.bfloat16, torch.float32, False, 0),
        ("awkward_odd_stride", (3, 5), 252, torch.bfloat16, torch.bfloat16, False, 251),
    ]
    for name, lead, d, dtype, wdtype, timed, beside in gated_cases:
        yv = rand(gen, (*lead, d), dtype)
        z = sliced(gen, lead, (d, beside), dtype)[0] if beside else rand(gen, (*lead, d), dtype)
        assert z.is_contiguous() == (beside == 0)
        w = (1.0 + 0.1 * rand(gen, (d,), torch.float32)).to(wdtype)
        out = fused_gated_rms_norm(yv, z, w, 1e-5)
        torch.cuda.synchronize()
        out_ref = gated_rms_norm_plain(yv, z, w, 1e-5)
        eo, ro = errors(out, out_ref)
        rec = {"kernel": "gated_rms_norm", "case": name, "shape": (*lead, d), "dtype": str(dtype),
               "z": "slice of a wider matrix" if beside else "contiguous",
               "out_abs_err": eo, "out_err_of_allowed": ro, "rtol": RTOL[dtype],
               "atol_rel": ATOL_REL}
        assert ro <= 1.0, rec
        if timed:
            moved = nbytes(yv, z, w, out)
            rows = yv.numel() // d
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 10 * rows * d / PEAK_OPS[torch.float32] * 1e3
            rec.update(
                ms=time_ms(lambda: fused_gated_rms_norm(yv, z, w, 1e-5), 100),
                host_us=host_us(lambda: fused_gated_rms_norm(yv, z, w, 1e-5)),
                plain_ms=time_ms(lambda: gated_rms_norm_plain(yv, z, w, 1e-5), 20),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, library_ms=None,
            )
            rec["kernel_name"] = norm_kernel_names(lambda: fused_gated_rms_norm(yv, z, w, 1e-5))
            if name == "decode":
                results["gated_rms_norm"] = dict(rec, max_abs_err=eo)
            else:
                results["gated_rms_norm"][name] = {
                    k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bytes_moved", "kernel_name")}
        emit({"kernel_check": rec})
    check_norm_rows(gen, results)


# K3a and K3b at decode's rows: `norm_rows_kernel` of csrc/norms.cu where
# norm_rows_fits holds (bf16 rows of d = 1024 E, E <= 4, at most NORM_ROWS_MAX
# of them); the row-per-block kernels (`add_rms_norm_kernel`,
# `gated_rms_norm_kernel`) elsewhere, and for every shape in the build with
# OMT_K3_SKIP=16
NORM_ROWS_KERNEL, NORM_ROWS_MAX = "norm_rows_kernel", 256
NORM_ENTRIES = ("omt_add_rms_norm", "omt_gated_rms_norm")


def norm_kernel_names(fn) -> list:
    return [n for n in kernel_names(fn) if "norm" in n]


def norm_parent_entries() -> dict:
    """The two forward entries of norms.cu built with OMT_K3_SKIP=16: the
    row-per-block kernels for every shape, the parent of norm_rows_kernel's."""
    return {e: variant_entry("norms.cu", e, "OMT_K3_SKIP", 16) for e in NORM_ENTRIES}


@contextlib.contextmanager
def parent_norms(entries: dict):
    """The norm wrappers launch the parent kernels (`norm_parent_entries`) while inside."""
    with only(NORM_ENTRIES[0], entries[NORM_ENTRIES[0]]), only(NORM_ENTRIES[1], entries[NORM_ENTRIES[1]]):
        yield


def norm_rows_inputs(gen, kind: str, rows: int, d: int, wdtype, variant: str):
    """(x, residual or None, w) of K3a ("add"; variant "residual" or
    "no_residual") or (y, z, w) of K3b ("gated"; z "z_slice", the first d
    columns of a wider matrix as the mixer passes it, or "z_contiguous"), bf16
    rows. The weight is made last: a call right after runs just behind the
    kernel that wrote it."""
    bf = torch.bfloat16
    a = rand(gen, (rows, d), bf)
    if kind == "add":
        b = rand(gen, (rows, d), torch.float32) if variant == "residual" else None
    elif variant == "z_slice":
        b = sliced(gen, (rows,), (d, 4096 + 256 + 64), bf)[0]
    else:
        b = rand(gen, (rows, d), bf)
    return a, b, (1.0 + 0.1 * rand(gen, (d,), torch.float32)).to(wdtype)


def norm_edge_inputs(kind: str, d: int, wdtype):
    """Rows built to hit the edges, (10, d): K3a's x (bf16) and residual (fp32);
    K3b's y and z (bf16). Row 0 zeros; 1 values near the largest finite (K3a:
    the residual near fp32's, so x + residual overflows in places); 2 near the
    smallest normal; 3 subnormals; 4 a sum of squares that overflows from
    finite squares; 5 NaN; 6 +inf and -inf; 7 K3a: x + residual cancelling to
    zero, K3b: z from -90 to -80 (expf(-z) near its overflow) and z = 88, 89;
    8 z = +-1e4 and +-inf with finite y; 9 magnitudes from 2^-60 to 2^60."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    R, f32, bf = 10, torch.float32, torch.bfloat16
    a = torch.randn((R, d), generator=gen, device="cuda")
    b = torch.randn((R, d), generator=gen, device="cuda")
    sign = torch.sign(torch.randn((R, d), generator=gen, device="cuda"))
    a[0], b[0] = 0.0, 0.0
    a[1] = 3.3e38 * sign[1]
    a[2], b[2] = a[2] * 1.2e-38, b[2] * 1.2e-38
    a[3], b[3] = a[3] * 3e-40, b[3] * 3e-42
    a[4] = 1e19 * sign[4]
    a[5, 7], b[5, 11], a[5, 100] = float("nan"), float("nan"), float("nan")
    a[6, 3], b[6, 5], a[6, 9], b[6, 13] = float("inf"), float("-inf"), float("-inf"), float("inf")
    a[9] = a[9] * torch.exp2(torch.randint(-60, 61, (d,), generator=gen, device="cuda").float())
    w = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(wdtype)
    if kind == "add":
        b[1] = 3.4e38 * sign[1]
        x = a.to(bf)
        b[7] = -x[7].float()
        b[7, ::2] = b[7, ::2] * 1.5
        return x, b.to(f32), w
    b[1], b[4] = 1.0, 10.0
    b[7] = -90.0 + 10.0 * torch.rand((d,), generator=gen, device="cuda")
    b[7, 0], b[7, 1] = 88.0, 89.0
    b[8] = 1e4 * sign[8]
    b[8, :4] = torch.tensor([float("inf"), float("-inf"), float("inf"), float("-inf")], device="cuda")
    return a.to(bf), b.to(bf), w


def weight_written_just_before(gen, fns: dict, parent: dict) -> dict:
    """K3a (d = 2048, a residual) and K3b (d = 4096, z a column slice) at
    BATCH rows, bf16 and fp32 weights, with a weight that the kernel launched
    just before the call wrote, against the parent kernel with the same weight
    settled, bit for bit: the last of a long copy into a buffer of NaNs, five
    times; a product and conversion made just before; `torch.ones` made after
    the rows; a strided weight that the wrapper copies. The decode-rows kernel
    runs behind the kernel ahead of it as a programmatic dependent, so a read of
    the weight before that kernel ends would show here."""
    rec = {}
    for kind, d, variant in (("add", 2048, "residual"), ("gated", 4096, "z_slice")):
        fn = fns[kind][0]
        for wdtype in (torch.bfloat16, torch.float32):
            a, b, w = norm_rows_inputs(gen, kind, BATCH, d, wdtype, variant)
            n = 1 << 25  # the copy ahead: 64 or 128 MB
            big = torch.empty((n + d,), dtype=wdtype, device="cuda")
            src = torch.cat([torch.zeros((n,), dtype=wdtype, device="cuda"), w])
            ones = torch.ones((d,), dtype=wdtype, device="cuda")
            w_strided = torch.stack([w, w], -1)[:, 0]
            assert not w_strided.is_contiguous()
            with parent_norms(parent):
                want = _as_tuple(fn(a, b, w, 1e-5))
                want_ones = _as_tuple(fn(a, b, ones, 1e-5))
            torch.cuda.synchronize()
            got = []
            for _ in range(5):
                big.fill_(float("nan"))
                torch.cuda.synchronize()
                big.copy_(src)
                got.append(_as_tuple(fn(a, b, big[n:], 1e-5)))
            got.append(_as_tuple(fn(a, b, w.float().mul(1.0).to(wdtype), 1e-5)))
            got.append(_as_tuple(fn(a, b, w_strided, 1e-5)))
            torch.cuda.synchronize()
            a2, b2 = a.clone(), b.clone()  # the rows, then the weight
            got_ones = _as_tuple(fn(a2, b2, torch.ones((d,), dtype=wdtype, device="cuda"), 1e-5))
            key = f"{kind} {wdtype}"
            rec[key] = [all(bits_equal(g, p) for g, p in zip(outs, want)) for outs in got] + [
                all(bits_equal(g, p) for g, p in zip(got_ones, want_ones))]
            assert all(rec[key]), (key, rec[key])
            names = set()
            for _ in range(3):
                names |= set(norm_kernel_names(lambda: fn(a, b, w_strided, 1e-5)))
                if any(NORM_ROWS_KERNEL in nm for nm in names):
                    break
            assert any(NORM_ROWS_KERNEL in nm for nm in names), (key, names)
            del big, src
    return rec


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_norm_rows(gen, results):
    """K3a and K3b at decode's rows against the parent kernels (the
    row-per-block kernels, `norm_parent_entries`) bit for bit: out and y, NaNs
    by payload, at rows 1, 16, 48, 96, 256, NORM_ROWS_MAX and one more (the
    parent kernel on both sides) of d = 1024, 2048, 3072, 4096, K3a with and
    without a residual, K3b with z contiguous and a column slice, bf16 and
    fp32 weights, each also within tolerance of the plain version; which
    kernel each case ran, by profiler name; the edge rows of
    `norm_edge_inputs`; a weight that the kernel just ahead wrote
    (`weight_written_just_before`). Then the device time of each at rows 1,
    16, 48, 96, 256 and NORM_ROWS_MAX (K3a d = 2048 with a residual, K3b
    d = 4096 with z a column slice, bf16 weights), each launch on the next of
    STATE_LAYERS inputs, back to back (`time_ms`) and one launch alone
    (`time_alone_ms`), beside the parent kernel in the same process."""
    from omnimamba_tpu_torch.ops.norms import add_norm_plain, gated_rms_norm_plain
    from omnimamba_tpu_torch.ops.norms_kernel import fused_add_rms_norm, fused_gated_rms_norm

    parent = norm_parent_entries()
    fns = {"add": (fused_add_rms_norm, add_norm_plain), "gated": (fused_gated_rms_norm, gated_rms_norm_plain)}
    variants = {"add": ("residual", "no_residual"), "gated": ("z_slice", "z_contiguous")}
    bf, f32 = torch.bfloat16, torch.float32
    groups, worst = {}, 0.0
    for kind, (fn, plain) in fns.items():
        for d in (1024, 2048, 3072, 4096):
            for variant in variants[kind]:
                for wdtype in (bf, f32):
                    calls = groups.setdefault((kind, d, variant, wdtype), [])
                    for rows in sorted({1, 16, 48, 96, 256, NORM_ROWS_MAX, NORM_ROWS_MAX + 1}):
                        args = norm_rows_inputs(gen, kind, rows, d, wdtype, variant)
                        got = _as_tuple(fn(*args, 1e-5))
                        with parent_norms(parent):
                            want = _as_tuple(fn(*args, 1e-5))
                        ref = _as_tuple(plain(*args, 1e-5))
                        rec = {"kernel": kind, "rows": rows, "d": d, "variant": variant,
                               "weight": str(wdtype)}
                        differ = [int((_bits(g) != _bits(p)).sum()) for g, p in zip(got, want)]
                        assert not any(differ), dict(rec, elements_that_differ=differ)
                        _, r = errors(got[0], ref[0])
                        worst = max(worst, r)
                        assert r <= 1.0 and (kind == "gated" or torch.equal(got[1], ref[1])), rec
                        calls.append(lambda fn=fn, args=args: fn(*args, 1e-5))
    # which kernel each group of cases ran, by profiler name: the decode-rows
    # kernel of the group's template arguments up to NORM_ROWS_MAX rows, the
    # parent beyond. A trace now and then lacks a kernel launched as a
    # programmatic dependent, so a group takes up to three traces.
    taken = {}
    for (kind, d, variant, wdtype), calls in groups.items():
        new = (f"{NORM_ROWS_KERNEL}<{str(kind == 'gated').lower()}, {d // 1024}, "
               f"{'__nv_bfloat16' if wdtype == bf else 'float'}, {str(variant == 'residual').lower()}>")
        old = f"{kind}_rms_norm_kernel"
        seen = set()
        for _ in range(3):
            seen |= set(kernel_names_per_call(calls + calls, "norm"))
            if any(new in n for n in seen) and any(old in n for n in seen):
                break
        key = (kind, d, variant, str(wdtype))
        assert all(new in n or old in n for n in seen), (key, seen)
        assert any(new in n for n in seen) and any(old in n for n in seen), (key, seen)
        for n in seen:
            taken[n] = taken.get(n, 0) + 1
    n_cases = sum(len(c) for c in groups.values())
    edges = {}
    for kind, (fn, _) in fns.items():
        for d in (1024, 2048, 3072, 4096):
            for wdtype in (bf, f32):
                args = norm_edge_inputs(kind, d, wdtype)
                got = _as_tuple(fn(*args, 1e-5))
                with parent_norms(parent):
                    want = _as_tuple(fn(*args, 1e-5))
                key = f"{kind} d={d} {wdtype}"
                edges[key] = {"bits_equal": all(bits_equal(g, p) for g, p in zip(got, want)),
                              "nonfinite_out": int((~torch.isfinite(got[0].float())).sum()),
                              "rows_that_differ": [
                                  int(r) for g, p in zip(got, want)
                                  for r in torch.nonzero((_bits(g) != _bits(p)).any(-1)).flatten()]}
                assert edges[key]["bits_equal"], (key, edges[key])
    fresh = weight_written_just_before(gen, fns, parent)
    rec = {"kernel": "norm_rows", "cases": n_cases, "bits_equal_to_the_parent_kernel": True,
           "weight_written_just_before": fresh,
           "worst_out_err_of_allowed_against_plain": worst, "edge_rows": edges,
           "kernel_names_and_groups": taken}
    emit({"kernel_check": rec})

    times = {}
    for kind, d, variant in (("add", 2048, "residual"), ("gated", 4096, "z_slice")):
        fn = fns[kind][0]
        times[kind] = {}
        for rows in sorted({1, 16, BATCH, 96, 256, NORM_ROWS_MAX}):
            layers = [norm_rows_inputs(gen, kind, rows, d, bf, variant) for _ in range(STATE_LAYERS)]
            turn = iter(range(1 << 30))

            def call():
                return fn(*layers[next(turn) % STATE_LAYERS], 1e-5)

            outs = _as_tuple(call())
            moved = nbytes(*layers[0]) + nbytes(*outs)
            if kind == "gated":  # the slice's rows, not the matrix it lies in
                moved = nbytes(layers[0][0], layers[0][2], *outs) + layers[0][1].numel() * 2
            n = 2 * STATE_LAYERS
            rec = {"rows": rows, "d": d, "bytes_moved": moved,
                   "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "ms": time_ms(call, n), "ms_alone": time_alone_ms(call, n)}
            with parent_norms(parent):
                rec.update(parent_ms=time_ms(call, n), parent_ms_alone=time_alone_ms(call, n))
            rec["ms_again"] = time_ms(call, n)
            times[kind][rows] = rec
            del layers
    emit({"kernel_check": {"kernel": "norm_rows", "times_from_48_inputs": times}})
    for kind, name in (("add", "add_rms_norm"), ("gated", "gated_rms_norm")):
        results[name]["decode_rows"] = times[kind]
        results[name]["ms_from_hbm"] = times[kind][BATCH]["ms"]
        results[name]["parent_kernel_ms_from_hbm"] = times[kind][BATCH]["parent_ms"]


# K6b's cases: name, rows-shape, d, dtype, weight dtype, timed, columns beside z
# in its matrix, and whether the row kernel (`gated_rms_norm_bwd_row_kernel`:
# bf16 rows of 1024 J elements, J <= 4, starting on 16 bytes) takes it rather
# than `gated_rms_norm_bwd_kernel`. On the training path z is a column slice of
# the in_proj output, y is the scan's output and g the out_proj's input
# cotangent, both contiguous.
_bf, _f32 = torch.bfloat16, torch.float32
GATED_BWD_CASES = [
    ("train", (TRAIN_BATCH, TRAIN_LEN), 4096, _bf, _bf, True, 4096 + 256 + 64, True),
    ("train_b9", (TRAIN_BATCH // 10, TRAIN_LEN), 4096, _bf, _bf, True, 4096 + 256 + 64, True),
    ("fp32", (5, 7), 4096, _f32, _f32, False, 4096 + 256 + 64, False),
    ("awkward", (3, 5), 250, _f32, _bf, False, 0, False),
    ("awkward_bf16", (7,), 1001, _bf, _f32, False, 0, False),
    ("awkward_odd_stride", (3, 5), 252, _bf, _bf, False, 251, False),
    ("more_rows_than_blocks", (1200,), 252, _bf, _bf, False, 0, False),
    ("d2048_bf16", (5, 7), 2048, _bf, _bf, False, 0, True),
    ("d1024_fp32_weight", (3, 5), 1024, _bf, _f32, False, 0, True),
    ("d3072_z_slice", (4, 5), 3072, _bf, _bf, False, 64, True),
    ("d2048_row_stride_of_4", (5, 7), 2048, _bf, _bf, False, 4, False),
]


def gated_bwd_inputs(gen, lead, d, dtype, wdtype, beside):
    """y, z (a column slice where `beside` columns lie next to it), g and the
    weight of one of `GATED_BWD_CASES`."""
    yv = rand(gen, (*lead, d), dtype)
    z = sliced(gen, lead, (d, beside), dtype)[0] if beside else rand(gen, (*lead, d), dtype)
    g = rand(gen, (*lead, d), dtype)
    w = (1.0 + 0.1 * rand(gen, (d,), torch.float32)).to(wdtype)
    return yv, z, g, w


def check_norms_bwd(gen, results):
    """K6a and K6b against their plain versions, at one layer of the training
    step and at awkward shapes; for K6b, which of its two kernels each case ran
    (profiler names) and how many of its blocks fit on an SM."""
    from omnimamba_tpu_torch.ops.norms import add_norm_bwd_plain, gated_rms_norm_bwd_plain
    from omnimamba_tpu_torch.ops.norms_kernel import (
        BWD_BLOCKS, fused_add_rms_norm_bwd, fused_gated_rms_norm_bwd, gated_bwd_blocks_per_sm)

    bf, f32 = torch.bfloat16, torch.float32
    train = (TRAIN_BATCH, TRAIN_LEN)
    # name, rows-shape, d, g dtype, weight dtype, with dres, with dy out, timed
    add_cases = [
        ("train", train, 2048, bf, bf, True, True, True),
        ("no_dres", train, 2048, bf, bf, False, True, False),
        ("first_block_no_dy", (BATCH, PROMPT), 2048, bf, bf, True, False, False),
        ("fp32", (5, 7), 2048, f32, f32, True, True, False),
        ("one_row", (1,), 2048, f32, f32, False, True, False),
        ("awkward", (3, 5), 250, f32, bf, False, True, False),
        ("awkward_bf16", (7,), 1001, bf, f32, True, True, False),
        ("more_rows_than_blocks", (1200,), 252, bf, bf, True, True, False),
        ("g_and_dres_column_slices", (5, 7), 256, bf, bf, True, True, False),
    ]
    for name, lead, d, dtype, wdtype, with_dres, with_dy, timed in add_cases:
        strided = name == "g_and_dres_column_slices"
        y = rand(gen, (*lead, d), f32)
        g = sliced(gen, lead, (d, 64), dtype)[0] if strided else rand(gen, (*lead, d), dtype)
        dres = rand(gen, (*lead, d), f32) if with_dres else None
        if strided:
            dres = sliced(gen, lead, (32, d), f32)[1]
            assert not g.is_contiguous() and not dres.is_contiguous()
        w = (1.0 + 0.1 * rand(gen, (d,), f32)).to(wdtype)
        dx, dy, dw = fused_add_rms_norm_bwd(y, g, w, dres, 1e-5, with_dy=with_dy)
        torch.cuda.synchronize()
        dw2 = fused_add_rms_norm_bwd(y, g, w, dres, 1e-5, with_dy=with_dy)[2]
        dx_ref, dy_ref, dw_ref = add_norm_bwd_plain(y, g, w, dres, 1e-5)
        assert (dy is None) == (not with_dy)
        ex, rx = errors(dx, dx_ref)
        ey, ry = errors(dy, dy_ref) if with_dy else (0.0, 0.0)
        ew, rw = errors(dw, dw_ref)
        rec = {"kernel": "add_rms_norm_bwd", "case": name, "shape": (*lead, d), "dtype": str(dtype),
               "weight_dtype": str(wdtype), "dres": with_dres, "dy_out": with_dy,
               "dx_abs_err": ex, "dx_err_of_allowed": rx, "dy_abs_err": ey, "dy_err_of_allowed": ry,
               "dw_abs_err": ew, "dw_err_of_allowed": rw, "dw_max": dw_ref.abs().max().item(),
               "rtol": RTOL[dtype], "atol_rel": ATOL_REL,
               "same_bits_on_a_second_run": bool(torch.equal(dw, dw2))}
        assert rx <= 1.0 and ry <= 1.0 and rw <= 1.0 and rec["same_bits_on_a_second_run"], rec
        if timed:
            moved = nbytes(y, g, w, dres, dx, dy, dw)
            rows = y.numel() // d
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 12 * rows * d / PEAK_OPS[f32] * 1e3
            # yardstick: the backward of F.rms_norm through autograd (the norm half
            # only: no cotangent of the stream added, no fp32 stream written)
            lib_ms = None
            if hasattr(F, "rms_norm"):
                summed = y.to(dtype).requires_grad_()
                wl = w.clone().requires_grad_()
                out = F.rms_norm(summed, (d,), wl, 1e-5)
                lib_ms = time_ms(lambda: torch.autograd.grad(out, (summed, wl), g, retain_graph=True), 20)
                del out, summed
            rec.update(
                ms=time_ms(lambda: fused_add_rms_norm_bwd(y, g, w, dres, 1e-5), 20),
                host_us=host_us(lambda: fused_add_rms_norm_bwd(y, g, w, dres, 1e-5), 50),
                plain_ms=time_ms(lambda: add_norm_bwd_plain(y, g, w, dres, 1e-5), 5),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, library_ms=lib_ms,
            )
            results["add_rms_norm_bwd"] = dict(rec, max_abs_err=max(ex, ey, ew))
        emit({"kernel_check": rec})

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launches = []  # one call of each case, for the kernel names below
    for name, lead, d, dtype, wdtype, timed, beside, row_kernel in GATED_BWD_CASES:
        yv, z, g, w = gated_bwd_inputs(gen, lead, d, dtype, wdtype, beside)
        dy, dz, dw = fused_gated_rms_norm_bwd(yv, z, g, w, 1e-5)
        torch.cuda.synchronize()
        dw2 = fused_gated_rms_norm_bwd(yv, z, g, w, 1e-5)[2]
        dy_ref, dz_ref, dw_ref = gated_rms_norm_bwd_plain(yv, z, g, w, 1e-5)
        ey, ry = errors(dy, dy_ref)
        ez, rz = errors(dz, dz_ref)
        ew, rw = errors(dw, dw_ref)
        rec = {"kernel": "gated_rms_norm_bwd", "case": name, "shape": (*lead, d), "dtype": str(dtype),
               "weight_dtype": str(wdtype), "z": "slice of a wider matrix" if beside else "contiguous",
               "dy_abs_err": ey, "dy_err_of_allowed": ry, "dz_abs_err": ez, "dz_err_of_allowed": rz,
               "dw_abs_err": ew, "dw_err_of_allowed": rw, "dw_max": dw_ref.abs().max().item(),
               "rtol": RTOL[dtype], "atol_rel": ATOL_REL,
               "same_bits_on_a_second_run": bool(torch.equal(dw, dw2))}
        assert ry <= 1.0 and rz <= 1.0 and rw <= 1.0 and rec["same_bits_on_a_second_run"], rec
        rec["blocks_per_sm"] = gated_bwd_blocks_per_sm(yv, z, g, w)
        # the row kernel's grid (at most BWD_BLOCKS) runs in one wave
        assert not row_kernel or rec["blocks_per_sm"] * sms >= BWD_BLOCKS, rec
        launches.append(lambda yv=yv, z=z, g=g, w=w: fused_gated_rms_norm_bwd(yv, z, g, w, 1e-5))
        if name == "train" and results.get("build_log"):  # its 8 instantiations: no spills
            rec["ptxas"] = ptxas_of(results["build_log"], "gated_rms_norm_bwd_row_kernel")
            assert rec["ptxas"] and len(rec["ptxas"]) == 8 and all(
                "0 bytes spill stores" in " ".join(v) for v in rec["ptxas"].values()), rec["ptxas"]
        if timed:
            moved = nbytes(yv, z, g, w, dy, dz, dw)
            rows = yv.numel() // d
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 30 * rows * d / PEAK_OPS[f32] * 1e3
            rec.update(
                ms=time_ms(lambda: fused_gated_rms_norm_bwd(yv, z, g, w, 1e-5), 20),
                host_us=host_us(lambda: fused_gated_rms_norm_bwd(yv, z, g, w, 1e-5), 50),
                plain_ms=time_ms(lambda: gated_rms_norm_bwd_plain(yv, z, g, w, 1e-5), 5),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, library_ms=None,
            )
            if name == "train":
                results["gated_rms_norm_bwd"] = dict(rec, max_abs_err=max(ey, ez, ew))
            else:
                results["gated_rms_norm_bwd"][name] = {
                    k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bytes_moved")}
        emit({"kernel_check": rec})

    # which of K6b's two kernels each case ran, by name, from one trace of them all
    ran = kernel_names_per_call(launches, "gated_rms_norm_bwd")
    rec = {"kernel": "gated_rms_norm_bwd", "case": "kernel_of_each_case",
           "kernel_name": {c[0]: k for c, k in zip(GATED_BWD_CASES, ran)}}
    emit({"kernel_check": rec})
    assert len(ran) == len(GATED_BWD_CASES), rec
    for (name, *_, row_kernel), k in zip(GATED_BWD_CASES, ran):
        want = "gated_rms_norm_bwd_row_kernel<" if row_kernel else "gated_rms_norm_bwd_kernel<"
        assert want in k, (name, k)
    results["gated_rms_norm_bwd"]["kernel_name"] = ran[0]


def fused_layers(gen, n_layer, mixer_cfg, lora_cfg, wdtype):
    """`n_layer` random layers for the whole-model decode step: the model's
    own init, then LoRA B factors, norm weights and D moved off their
    constant initial values so that every operand counts."""
    from omnimamba_tpu_torch.models.mamba2 import init_mamba2

    dev = torch.device("cuda")
    layers = []
    for _ in range(n_layer):
        mixer = init_mamba2(gen, mixer_cfg, lora_cfg, max(n_layer, 1), torch.float32, dev)
        mixer["D"] = 1.0 + 0.2 * rand(gen, mixer["D"].shape, torch.float32)
        mixer["norm"]["weight"] = 1.0 + 0.1 * rand(gen, mixer["norm"]["weight"].shape, torch.float32)
        for k in mixer.get("lora", {}):
            if k.endswith("_B"):
                mixer["lora"][k] = 0.02 * rand(gen, mixer["lora"][k].shape, torch.float32)
        layer = {"norm": {"weight": 1.0 + 0.1 * rand(gen, (mixer_cfg.d_model,), torch.float32)},
                 "mixer": mixer}
        layers.append(_cast(layer, wdtype))
    return layers


def _cast(node, dtype):
    if isinstance(node, dict):
        return {k: _cast(v, dtype) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_cast(v, dtype) for v in node)
    return node.to(dtype).contiguous()


def fused_state(gen, n_layer, B, mixer_cfg, io, sdtype):
    from omnimamba_tpu_torch.models.backbone import BackboneCache

    conv = rand(gen, (n_layer, B, mixer_cfg.d_conv - 1, mixer_cfg.d_conv_in), io, 0.5)
    ssm = rand(gen, (n_layer, B, mixer_cfg.nheads, mixer_cfg.headdim, mixer_cfg.d_state), sdtype, 0.5)
    return BackboneCache(conv, ssm)


def fused_step_bytes(layers, cache, h, lora_task):
    """Bytes one token step must move: every layer operand the step reads
    once (the other task's LoRA is not read), the conv windows and SSM states
    read and written, h in and out, the fp32 residual out."""
    skip = {f"{t}_{ab}" for t in ("t2i", "mmu") if t != lora_task for ab in "AB"}
    weights = sum(nbytes(t) for name, t in _named_leaves(layers) if name not in skip)
    return weights + 2 * nbytes(cache.conv_state, cache.ssm_state) + 2 * nbytes(h) + 4 * h.numel()


def fused_step_flops(B, n_layer, cfg, r):
    """Multiply-adds (x2) of the two products, the LoRA branch and the SSM update."""
    per_layer = (2 * B * cfg.d_model * cfg.d_in_proj + 2 * B * cfg.d_inner * cfg.d_model
                 + 2 * B * r * (cfg.d_model + cfg.d_in_proj)
                 + 5 * B * cfg.nheads * cfg.headdim * cfg.d_state)
    return n_layer * per_layer


# Tolerances of the whole-model decode step. With fp32 activations kernel and
# plain version differ by the order of their fp32 sums only, and every output
# element is held by the rule of the other kernels (RTOL, ATOL_REL), through 1
# and through 4 layers. With bf16 activations the step rounds inside: the
# normed hidden state, the gated yf * w and the layer output go to bf16. Kernel
# and plain version sum the row's mean square in another order, so a few of the
# 48 x 2048 normed values round the other way (measured: 2 to 10 rows of one
# layer hold one). One such flip, 2^-8 of a value up to 4, moves every in_proj
# output of its row by up to 4 * 2^-8 * max|W| = 3e-4, and the row's outputs by
# the same share: 1.6e-4 of the largest value was measured. So a bf16 step of
# one layer is held to RTOL plus 2^-10 of the largest reference value.
BF16_STEP_ATOL_REL = 2.0 ** -10
# Through 48 layers in bf16 every flipped value feeds the next layer's products
# and the streams drift apart like two bf16 runs of one model (measured: up to
# 0.5% of the largest value, 0.06% on average). h, the residual and what is
# written to the caches are held to 2^-6 of the largest reference value,
# element by element, and the mean error to a tenth of that.
DEEP_TOL_REL = 2.0 ** -6


def check_decode_fused(gen, results):
    from omnimamba_tpu_torch.config import LoraConfig, Mamba2LayerConfig
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_limits, fused_decode_step, fused_decode_step_plain, prepare_fused_decode)

    full, lora8 = Mamba2LayerConfig(), LoraConfig()
    # d_in_proj = 139: no 4-element alignment anywhere, K = 24 below one k tile
    narrow = Mamba2LayerConfig(d_model=24, d_state=20, headdim=16, d_conv=3)
    # state tiles that the SSM phase's tile kernel does not take (P not a
    # multiple of 8; N above 128): the step kernel's row code runs them
    narrow_p12 = Mamba2LayerConfig(d_model=24, d_state=20, headdim=12, d_conv=3)
    narrow_n132 = Mamba2LayerConfig(d_model=24, d_state=132, headdim=16, d_conv=3)
    # whole tensor-core tiles at other widths (in_proj widths 4,416 and 6,464):
    # the early pre-norm takes d = 1,024 (both of its instantiations there,
    # with and without LoRA); d = 1,536 is not a whole number of its rows, so
    # the pre-norm there is k4_prenorm_kernel beside the tensor-core products
    d1024 = Mamba2LayerConfig(d_model=1024, headdim=32)
    d1536 = Mamba2LayerConfig(d_model=1536, headdim=48)
    bf, f32 = torch.bfloat16, torch.float32
    # name: layers, mixer cfg, lora cfg, weight dtype; each stack is made once
    sizes = {"full_bf16": (48, full, lora8, bf), "full_f32": (48, full, lora8, f32),
             "narrow_f32": (2, narrow, LoraConfig(r=4), f32),
             "narrow_bf16": (2, narrow, LoraConfig(r=4), bf),
             "narrow_p12_bf16": (2, narrow_p12, LoraConfig(r=4), bf),
             "narrow_n132_f32": (2, narrow_n132, LoraConfig(r=4), f32),
             "d1024_bf16": (1, d1024, lora8, bf), "d1536_bf16": (1, d1536, lora8, bf)}
    stacks = {}

    def stack(name):
        if name not in stacks:
            stacks[name] = fused_layers(gen, *sizes[name])
        return stacks[name]

    cases = [
        # name, stack, layers used, B, mixer cfg, lora cfg, task, io, weights, state
        ("main_1_layer", "full_bf16", 1, BATCH, full, lora8, "t2i", bf, bf, bf),
        ("fp32_state", "full_bf16", 1, BATCH, full, lora8, "mmu", bf, bf, f32),
        ("cfg_batch_no_lora", "full_bf16", 1, 2 * BATCH, full, lora8, None, bf, bf, bf),
        ("three_rows", "full_bf16", 1, 3, full, lora8, "t2i", bf, bf, bf),
        ("twenty_rows", "full_bf16", 1, 20, full, lora8, "mmu", bf, bf, f32),
        ("one_row_fp32", "full_f32", 1, 1, full, lora8, "t2i", f32, f32, bf),
        ("three_rows_fp32", "full_f32", 1, 3, full, lora8, "t2i", f32, f32, f32),
        ("four_layers_fp32", "full_f32", 4, BATCH, full, lora8, "t2i", f32, f32, f32),
        ("awkward", "narrow_f32", 2, 3, narrow, LoraConfig(r=4), "t2i", f32, f32, f32),
        ("awkward_bf16", "narrow_bf16", 2, 5, narrow, LoraConfig(r=4), "mmu", bf, bf, bf),
        ("awkward_head_dim_12_bf16", "narrow_p12_bf16", 2, 5, narrow_p12, LoraConfig(r=4), "t2i",
         bf, bf, bf),
        ("awkward_d_state_132", "narrow_n132_f32", 2, 3, narrow_n132, LoraConfig(r=4), "mmu",
         f32, f32, f32),
        ("main", "full_bf16", 48, BATCH, full, lora8, "t2i", bf, bf, bf),
        ("d_model_1024_bf16", "d1024_bf16", 1, BATCH, d1024, lora8, "t2i", bf, bf, bf),
        ("d_model_1024_no_lora_bf16", "d1024_bf16", 1, 2 * BATCH, d1024, lora8, None, bf, bf, bf),
        ("d_model_1536_bf16", "d1536_bf16", 1, BATCH, d1536, lora8, "t2i", bf, bf, bf),
        # above 96 rows: both pair kernels with two row tiles of 96
        ("rows_112_bf16", "full_bf16", 1, 112, full, lora8, "t2i", bf, bf, bf),
    ]
    # the pre-norm kernel each bf16 case on whole tiles must run (by name)
    prenorm_of = {"main_1_layer": "k4_prenorm_early_kernel<2, 8>",
                  "cfg_batch_no_lora": "k4_prenorm_early_kernel<2, 0>",
                  "d_model_1024_bf16": "k4_prenorm_early_kernel<1, 8>",
                  "d_model_1024_no_lora_bf16": "k4_prenorm_early_kernel<1, 0>",
                  "d_model_1536_bf16": "k4_prenorm_kernel<",
                  "rows_112_bf16": "k4_prenorm_early_kernel<2, 8>"}
    # the out_proj kernel each bf16 case on whole tiles must run (by name): the
    # pair kernel of bf16 weights with MT m16 row fragments a block (six from
    # B=96 on: 96 rows a block, one row tile at B=96, two at 112)
    out_proj_of = {"main_1_layer": "k4_out_proj_pair_kernel<3, __nv_bfloat16>",
                   "three_rows": "k4_out_proj_pair_kernel<1, __nv_bfloat16>",
                   "twenty_rows": "k4_out_proj_pair_kernel<2, __nv_bfloat16>",
                   "cfg_batch_no_lora": "k4_out_proj_pair_kernel<6, __nv_bfloat16>",
                   "d_model_1024_bf16": "k4_out_proj_pair_kernel<3, __nv_bfloat16>",
                   "d_model_1536_bf16": "k4_out_proj_pair_kernel<3, __nv_bfloat16>",
                   "rows_112_bf16": "k4_out_proj_pair_kernel<6, __nv_bfloat16>"}
    for name, sname, n_layer, B, cfg, lcfg, task, io, wdtype, sdtype in cases:
        layers = stack(sname)[:n_layer]
        cache0 = fused_state(gen, n_layer, B, cfg, io, sdtype)
        h = rand(gen, (B, cfg.d_model), io)
        residual = rand(gen, (B, cfg.d_model), f32) if name != "main" else None
        args = (task, cfg, lcfg, 1e-5)

        ref_cache = cache0._replace(conv_state=cache0.conv_state.clone(),
                                    ssm_state=cache0.ssm_state.clone())
        h_ref, res_ref, _ = fused_decode_step_plain(layers, h, residual, ref_cache, *args)
        cache = cache0._replace(conv_state=cache0.conv_state.clone(),
                                ssm_state=cache0.ssm_state.clone())
        plan = prepare_fused_decode(layers, task, cfg, lcfg, B, io)
        conv_ptr, ssm_ptr = cache.conv_state.data_ptr(), cache.ssm_state.data_ptr()
        h_out, res_out, cache_out = fused_decode_step(layers, h, residual, cache, *args, plan=plan)
        torch.cuda.synchronize()
        assert (cache_out.conv_state.data_ptr(), cache_out.ssm_state.data_ptr()) == (conv_ptr, ssm_ptr), \
            "the cache must be updated in place"
        pairs = {"h": (h_out, h_ref), "residual": (res_out, res_ref),
                 "conv_window": (cache.conv_state, ref_cache.conv_state),
                 "ssm_state": (cache.ssm_state, ref_cache.ssm_state)}
        rec = {"kernel": "decode_fused", "case": name, "layers": n_layer, "batch": B,
               "d_model": cfg.d_model, "task": task, "dtype": str(io), "weight_dtype": str(wdtype),
               "state_dtype": str(sdtype)}
        deep = n_layer > 4  # bf16 through many layers: see DEEP_TOL_REL
        worst = 0.0
        atol_rel = ATOL_REL if io == f32 else BF16_STEP_ATOL_REL
        for key, (got, want) in pairs.items():
            abs_err, share = errors(got, want, atol_rel)
            rec[f"{key}_abs_err"] = abs_err
            if deep:
                scale = want.float().abs().max().item()
                diff = (got.float() - want.float()).abs()
                share = abs_err / (DEEP_TOL_REL * scale)
                rec[f"{key}_mean_err_of_allowed"] = diff.mean().item() / (0.1 * DEEP_TOL_REL * scale)
                assert rec[f"{key}_mean_err_of_allowed"] <= 1.0, rec
            rec[f"{key}_err_of_allowed"] = share
            worst = max(worst, abs_err)
        rec.update({"tolerance": f"max and mean against {DEEP_TOL_REL} and {0.1 * DEEP_TOL_REL} "
                                 "of the largest reference value"} if deep else
                   {"rtol": {"fp32": 0.0, "bf16": RTOL[bf]}, "atol_rel": atol_rel})
        assert all(rec[f"{k}_err_of_allowed"] <= 1.0 for k in pairs), rec
        if name in ("main_1_layer", "twenty_rows"):
            # a row's bits do not depend on the batch: rows 0-2 of this step
            # equal the 3-row step on the same rows, weights, residual and cache rows
            c3 = cache0._replace(conv_state=cache0.conv_state[:, :3].clone(),
                                 ssm_state=cache0.ssm_state[:, :3].clone())
            h3, r3, _ = fused_decode_step(
                layers, h[:3].contiguous(), residual[:3].contiguous(), c3, *args,
                plan=prepare_fused_decode(layers, task, cfg, lcfg, 3, io))
            torch.cuda.synchronize()
            same = {"h": torch.equal(h3, h_out[:3]), "residual": torch.equal(r3, res_out[:3]),
                    "conv_window": torch.equal(c3.conv_state, cache.conv_state[:, :3]),
                    "ssm_state": torch.equal(c3.ssm_state, cache.ssm_state[:, :3])}
            rec["rows_0_to_2_equal_to_3_row_step"] = same
            assert all(same.values()), rec
        if name in prenorm_of:
            ran = [k for k in kernel_names(lambda: fused_decode_step(
                layers, h, residual, cache, *args, plan=plan)) if "k4_prenorm" in k]
            rec["prenorm_kernels"] = ran
            want = prenorm_of[name].replace(" ", "")
            assert ran and all(want in k.replace(" ", "") for k in ran), (name, ran)
        if name in out_proj_of:
            ran = [k for k in kernel_names(lambda: fused_decode_step(
                layers, h, residual, cache, *args, plan=plan)) if "k4_out_proj" in k]
            rec["out_proj_kernels"] = ran
            want = out_proj_of[name].replace(" ", "")
            assert ran and all(want in k.replace(" ", "") for k in ran), (name, ran)
        if name == "main":
            r = lcfg.r
            moved = fused_step_bytes(layers, cache, h, task)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            flops = fused_step_flops(B, n_layer, cfg, r)
            ops_ms = flops / PEAK_OPS[io] * 1e3

            def kernel_step():
                fused_decode_step(layers, h, residual, cache, *args, plan=plan)

            rec.update(
                ms=time_ms(kernel_step, 10),
                host_us=host_us(kernel_step, 20),
                plain_ms=time_ms(lambda: fused_decode_step_plain(
                    layers, h, residual, ref_cache, *args), 2, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, flops=flops,
                library_ms=None,
                library_note="no single PyTorch call computes a whole-model decode step; the "
                             "yardstick is the device time of one scan-path step (decode_profile)",
            )
            # the bf16-state rule of cache_dtype="auto" (B >= 16): the step with an
            # fp32 and a bf16 state at three batch sizes, same layers
            by_state = {}
            for b in (8, 16, BATCH):
                hb = h[:b].contiguous()
                pb = prepare_fused_decode(layers, task, cfg, lcfg, b, io)
                for sd in (f32, bf):
                    cb = fused_state(gen, n_layer, b, cfg, io, sd)
                    by_state[f"B{b}_{'fp32' if sd == f32 else 'bf16'}_state_ms"] = time_ms(
                        lambda: fused_decode_step(layers, hb, None, cb, *args, plan=pb), 10)
            rec["state_dtype_ms"] = by_state
            # device time per kernel of the step at a small batch (the main
            # batch's is in decode_profile)
            cb = fused_state(gen, n_layer, 8, cfg, io, bf)
            hb, pb = h[:8].contiguous(), prepare_fused_decode(layers, task, cfg, lcfg, 8, io)
            rec["small_batch_profile"] = dict(batch=8, **profile_steps(
                lambda i: fused_decode_step(layers, hb, None, cb, *args, plan=pb), 3))
            results["decode_fused"] = dict(rec, max_abs_err=worst, shape=(n_layer, B, cfg.d_model))
        emit({"kernel_check": rec})
        del cache0, cache, ref_cache, plan

    # activations of another type than the weights are refused, on the card as on the CPU
    assert isinstance(fused_decode_limits(stack("full_bf16")[:1], full, lora8, f32), ValueError)

    rec = in_proj_phase(gen, stack("full_bf16"), full, lora8, "t2i")
    if results.get("build_log"):  # every pair in_proj (bf16 and int8 W_in): no spills, tensor cores
        from omnimamba_tpu_torch.ops import kernel_build

        rec["ptxas"] = ptxas_of(results["build_log"], "k4_in_proj_pair")
        rec["sass"] = sass_counts(kernel_build.build_kernels().library, "k4_in_proj_pair",
                                  ("HMMA.16816.F32.BF16", "LDSM", "UTMALDG"))
        assert rec["ptxas"] and len(rec["ptxas"]) == 12 and all(
            "0 bytes spill stores" in " ".join(v) for v in rec["ptxas"].values()), rec["ptxas"]
        assert rec["sass"] and all(c["HMMA.16816.F32.BF16"] > 0 for c in rec["sass"].values()), \
            rec["sass"]
    emit({"kernel_check": rec})
    results["decode_fused"]["in_proj_phase"] = {k: rec[k] for k in ("by_batch", "ptxas", "sass")
                                                if k in rec}

    rec = prenorm_phase(gen, stack("full_bf16"), full, lora8, "t2i")
    if results.get("build_log"):  # every instantiation of the early pre-norm: no spills
        rec["ptxas"] = ptxas_of(results["build_log"], "k4_prenorm_early")
        assert rec["ptxas"] and len(rec["ptxas"]) == 4 and all(
            "0 bytes spill stores" in " ".join(v) for v in rec["ptxas"].values()), rec["ptxas"]
    emit({"kernel_check": rec})
    results["decode_fused"]["prenorm_phase"] = {k: rec[k] for k in ("by_batch", "ptxas")
                                                if k in rec}

    rec = out_proj_phase(gen, stack("full_bf16"), full, lora8, "t2i")
    if results.get("build_log"):  # every pair out_proj (bf16 and int8 W_out): no spills, tensor cores
        from omnimamba_tpu_torch.ops import kernel_build

        rec["ptxas"] = ptxas_of(results["build_log"], "k4_out_proj_pair")
        rec["sass"] = sass_counts(kernel_build.build_kernels().library, "k4_out_proj_pair",
                                  ("HMMA.16816.F32.BF16", "LDSM", "UTMALDG"))
        assert rec["ptxas"] and len(rec["ptxas"]) == 12 and all(
            "0 bytes spill stores" in " ".join(v) for v in rec["ptxas"].values()), rec["ptxas"]
        assert rec["sass"] and all(c["HMMA.16816.F32.BF16"] > 0 for c in rec["sass"].values()), \
            rec["sass"]
    emit({"kernel_check": rec})
    results["decode_fused"]["out_proj_phase"] = {k: rec[k] for k in ("by_batch", "ptxas", "sass")
                                                 if k in rec}

    rec = ssm_phase(gen, stack("full_bf16"), full, lora8, "t2i")
    if results.get("build_log"):  # every instantiation of the SSM phase's tile kernel: no spills
        rec["ptxas"] = ptxas_of(results["build_log"], "k4_ssm_tile")
        assert rec["ptxas"] and len(rec["ptxas"]) == 4 and all(
            "0 bytes spill stores" in " ".join(v) for v in rec["ptxas"].values()), rec["ptxas"]
    emit({"kernel_check": rec})
    results["decode_fused"]["ssm_phase"] = {k: rec[k] for k in ("by_case", "ptxas") if k in rec}

    # what decode_impl="auto" is decided on: one step of the whole-model kernel
    # against one step of the layer loop on the same 48 layers, for both types
    # generate() can hand over, at the main batch and at a small one
    against = {}
    for name, sname, B, io, sdtype in (
            ("bf16_B48", "full_bf16", BATCH, bf, bf), ("bf16_B4", "full_bf16", 4, bf, f32),
            ("fp32_B48", "full_f32", BATCH, f32, bf), ("fp32_B4", "full_f32", 4, f32, f32)):
        against[name] = step_pair_ms(gen, stack(sname), full, lora8, B, io, sdtype)
    emit({"kernel_check": {"kernel": "decode_fused", "case": "fused_against_scan", "layers": 48,
                           "ms": against}})
    results["decode_fused"]["fused_against_scan_ms"] = against
    stacks.clear()
    torch.cuda.empty_cache()


def kernel_names(fn, calls: int = 3, per_trace: int = 3) -> list:
    """The names of the device kernels that `calls` traces of `per_trace`
    calls of `fn` each launch. A trace now and then lacks a kernel that ran
    (seen for kernels launched as programmatic dependents: a one-layer step's
    in_proj was missing from three traces of one step each), so each trace
    takes several calls and the names of all the traces are taken together."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = set()
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(per_trace):
                fn()
            torch.cuda.synchronize()
        names |= {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    return sorted(names)


def kernel_names_per_call(fns, key: str) -> list:
    """The name of the device kernel holding `key` that each of `fns` launches
    (one each), in order, from one profiler trace of them all in turn, each
    call ended by a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
            torch.cuda.synchronize()
    return [name for _, name in sorted((e.time_range.start, e.name) for e in prof.events()
                                       if e.device_type == DeviceType.CUDA and key in e.name)]


def prenorm_phase(gen, layers, cfg, lcfg, task):
    """K4's bf16 pre-norm phase (the previous layer's out_proj finished, the
    residual add, the RMSNorm and hn @ A) of one layer alone, as the step
    launches it (`fused_decode_prenorm`, on a running residual it updates in
    place), at 16, 48 and 96 rows: device ms beside the bytes it must move at
    the card's memory rate, and beside `F.rms_norm` of the same (B, d) bf16
    rows with the layer's weight (the norm half only: no out_proj to finish,
    no residual, no hn @ A; it does not compute the phase's function, so
    library_ms stays null). Each launch takes the next of the 48 layers, so
    its weights come from device memory. Beside them the phase inside the
    48-layer step (profile of 3 steps): each kernel's time and the part of it
    that no earlier kernel overlaps."""
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_prenorm, fused_decode_step, prepare_fused_decode)

    bf = torch.bfloat16
    by_batch = {}
    for b in (16, BATCH, 2 * BATCH):
        h = rand(gen, (b, cfg.d_model), bf)
        residual = rand(gen, (b, cfg.d_model), torch.float32)
        cache = fused_state(gen, len(layers), b, cfg, bf, bf)
        plan = prepare_fused_decode(layers, task, cfg, lcfg, b, bf)
        args = (layers, h, None, cache, task, cfg, lcfg, 1e-5)
        fused_decode_step(*args, plan=plan)  # the scratch holds real partials and sums of squares
        norm_w = [layer["norm"]["weight"] for layer in layers]
        turn = [0]

        def phase():
            fused_decode_prenorm(layers, h, residual, *args[3:], plan=plan,
                                 layer=turn[0] % len(layers))
            turn[0] += 1

        def norm():
            F.rms_norm(h, (cfg.d_model,), norm_w[turn[0] % len(layers)], 1e-5)
            turn[0] += 1

        phase_bytes = k4_phase_bytes(cfg, lcfg.r, b)["k4_prenorm"]
        ms = time_ms(phase, 2 * len(layers))
        prof = profile_steps(lambda i: fused_decode_step(*args, plan=plan), 3, named=K4_PHASES)
        bound = phase_bytes / HBM_BYTES_PER_S * 1e3
        by_batch[f"B{b}"] = {
            "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms, "bytes": phase_bytes,
            "rms_norm_ms": time_ms(norm, 2 * len(layers)),
            "step_ms_per_layer": {k: v / len(layers) for k, v in prof["named_ms_per_step"].items()},
            "step_exposed_ms_per_layer": {
                k: v / len(layers) for k, v in prof["named_exposed_ms_per_step"].items()},
            "step_device_busy_ms": prof["device_busy_ms_per_step"],
        }
        del cache, plan
    return {"kernel": "decode_fused", "case": "prenorm_phase", "layers": 1, "d_model": cfg.d_model,
            "lora_rank": lcfg.r, "dtype": str(bf), "by_batch": by_batch,
            "rms_norm_note": "F.rms_norm of the (B, d) bf16 rows with the layer's weight: the "
                             "norm half alone (no out_proj to finish, no residual, no hn @ A), "
                             "a yardstick, not the phase's function"}


def in_proj_phase(gen, layers, cfg, lcfg, task):
    """K4's bf16 in_proj phase (the product with LoRA, conv step and softplus)
    of one layer alone, as the step launches it (`fused_decode_in_proj`), at 16,
    48 and 96 rows: device ms beside the bytes it must move at the card's memory
    rate, and the bare `torch.matmul(hn, W_in)` of the same shape (the product
    alone, without the LoRA term, the conv step and their bytes). Each launch
    takes the next of the 48 layers, so its weights come from device memory
    (one layer's 34.9 MB would stay in the 50 MB L2 between launches); the
    `_same_layer` times repeat one layer. Beside them the phase inside the
    48-layer step (profile of 3 steps): each kernel's time and the part of it
    that no earlier kernel overlaps."""
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_in_proj, fused_decode_step, prepare_fused_decode)

    bf = torch.bfloat16
    by_batch = {}
    for b in (16, BATCH, 2 * BATCH):
        h = rand(gen, (b, cfg.d_model), bf)
        cache = fused_state(gen, len(layers), b, cfg, bf, bf)
        plan = prepare_fused_decode(layers, task, cfg, lcfg, b, bf)
        args = (layers, h, None, cache, task, cfg, lcfg, 1e-5)
        fused_decode_step(*args, plan=plan)  # the scratch holds a real hn and hn @ A
        w_in = [layer["mixer"]["in_proj"]["kernel"] for layer in layers]
        hn, turn = plan.scratch["hn"], [0]

        def phase():
            fused_decode_in_proj(*args, plan=plan, layer=turn[0] % len(layers))
            turn[0] += 1

        def product():
            torch.matmul(hn, w_in[turn[0] % len(layers)])
            turn[0] += 1

        phase_bytes = k4_phase_bytes(cfg, lcfg.r, b)["k4_in_proj"]
        ms = time_ms(phase, 2 * len(layers))
        prof = profile_steps(lambda i: fused_decode_step(*args, plan=plan), 3, named=K4_PHASES)
        bound = phase_bytes / HBM_BYTES_PER_S * 1e3
        by_batch[f"B{b}"] = {
            "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms, "bytes": phase_bytes,
            "library_ms": time_ms(product, 2 * len(layers)),
            "ms_same_layer": time_ms(lambda: fused_decode_in_proj(*args, plan=plan, layer=0), 20),
            "library_ms_same_layer": time_ms(lambda: torch.matmul(hn, w_in[0]), 20),
            "step_ms_per_layer": {k: v / len(layers) for k, v in prof["named_ms_per_step"].items()},
            "step_exposed_ms_per_layer": {
                k: v / len(layers) for k, v in prof["named_exposed_ms_per_step"].items()},
            "step_device_busy_ms": prof["device_busy_ms_per_step"],
        }
        del cache, plan
    return {"kernel": "decode_fused", "case": "in_proj_phase", "layers": 1, "d_model": cfg.d_model,
            "d_in_proj": cfg.d_in_proj, "lora_rank": lcfg.r, "dtype": str(bf), "by_batch": by_batch,
            "library_note": "torch.matmul(hn, W_in): the product alone (no LoRA term, conv step "
                            "or softplus), the yardstick for the phase's product"}


def int8_phases(gen, layers, cfg, lcfg, task):
    """K4's two int8 phases of one layer alone, as the step launches them, at
    16, 48 and 96 rows, each launch on the next of the 48 layers: the in_proj
    (`fused_decode_in_proj`: the product with the int8 W_in and its column
    scale, the LoRA term, conv step and softplus) and the out_proj
    (`fused_decode_out_proj`: the gated, weighted yf times the int8 W_out into
    the fp32 K-split partials, each times the column scale), both on bf16
    activations. Launches back to back (`ms`, where each launch, a
    programmatic dependent of the one before, fetches weights while that one
    runs) and one launch with nothing beside it (`ms_alone`: `time_alone_ms`),
    beside the bytes the phase must move at the card's memory rate. Two
    yardsticks of each product alone, neither of them the phase's function:
    K7's `qmatmul(x, q, scale)`, the port's own int8 product, and
    `torch.matmul(x, q as bf16)`, a bf16 product of the same shape with twice
    the weight bytes. Beside them the phases inside the 48-layer int8 step
    (profile of 3 steps): each kernel's time and the part of it that no
    earlier kernel overlaps, all of the in_proj's and all of the out_proj's
    their pair kernels'. Returns the two records."""
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_in_proj, fused_decode_out_proj, fused_decode_step, prepare_fused_decode)
    from omnimamba_tpu_torch.ops.quant_kernel import qmatmul

    bf = torch.bfloat16
    # phase -> (launch, the scratch it multiplies, its int8 weights, their bf16 copies)
    products = {}
    for phase, launch, x, w in (("in_proj", fused_decode_in_proj, "hn", "in_proj"),
                                ("out_proj", fused_decode_out_proj, "ya", "out_proj")):
        ws = [layer["mixer"][w]["kernel"] for layer in layers]
        products[phase] = (launch, x, ws, [q["q"].to(bf) for q in ws])
    n = 2 * len(layers)
    by_batch = {phase: {} for phase in products}
    for b in (16, BATCH, 2 * BATCH):
        h = rand(gen, (b, cfg.d_model), bf)
        cache = fused_state(gen, len(layers), b, cfg, bf, bf)
        plan = prepare_fused_decode(layers, task, cfg, lcfg, b, bf)
        assert plan.proj_dtype == torch.int8
        assert plan.in_maps is not None and plan.out_maps is not None
        args = (layers, h, None, cache, task, cfg, lcfg, 1e-5)
        fused_decode_step(*args, plan=plan)  # the scratch holds a real hn, hn @ A and yf * w_gn
        prof = profile_steps(lambda i: fused_decode_step(*args, plan=plan), 3,
                             named=K4_PHASES + ("k4_in_proj_pair", "k4_out_proj_pair"))
        named = prof["named_ms_per_step"]
        for phase, (launch, xname, ws, w_bf16) in products.items():
            x, turn = plan.scratch[xname], [0]

            def run():
                launch(*args, plan=plan, layer=turn[0] % len(layers))
                turn[0] += 1

            def k7():
                w = ws[turn[0] % len(layers)]
                qmatmul(x, w["q"], w["scale"])
                turn[0] += 1

            def bf16_product():
                torch.matmul(x, w_bf16[turn[0] % len(layers)])
                turn[0] += 1

            phase_bytes = k4_phase_bytes(cfg, lcfg.r, b, proj_bytes=1)[f"k4_{phase}"]
            bound = phase_bytes / HBM_BYTES_PER_S * 1e3
            ms, ms_alone = time_ms(run, n), time_alone_ms(run, n)
            by_batch[phase][f"B{b}"] = {
                "ms": ms, "ms_alone": ms_alone, "bound_ms": bound, "share_of_bound": bound / ms,
                "share_of_bound_alone": bound / ms_alone, "bytes": phase_bytes,
                "qmatmul_ms": time_ms(k7, n), "qmatmul_ms_alone": time_alone_ms(k7, n),
                "bf16_matmul_ms": time_ms(bf16_product, n),
                "bf16_matmul_ms_alone": time_alone_ms(bf16_product, n),
                "step_ms_per_layer": {k: v / len(layers) for k, v in named.items()},
                "step_exposed_ms_per_layer": {
                    k: v / len(layers) for k, v in prof["named_exposed_ms_per_step"].items()},
                "step_device_busy_ms": prof["device_busy_ms_per_step"],
            }
            # the step's time of the phase is its pair kernel's, and only its
            assert 0 < named[f"k4_{phase}_pair"] == named[f"k4_{phase}"], by_batch[phase][f"B{b}"]
        del cache, plan
    common = {"kernel": "decode_fused_int8", "layers": 1, "d_model": cfg.d_model,
              "lora_rank": lcfg.r, "dtype": str(bf)}
    return (
        dict(common, case="int8_in_proj_phase", d_in_proj=cfg.d_in_proj,
             weight_dtype="int8 in_proj", by_batch=by_batch["in_proj"],
             yardstick_note="qmatmul(hn, q, scale): K7, the port's int8 product alone (no LoRA "
                            "term, conv step or softplus); torch.matmul(hn, q as bf16): a bf16 "
                            "product of the same shape, twice the weight bytes; neither computes "
                            "the phase's function, so library_ms stays null"),
        dict(common, case="int8_out_proj_phase", d_inner=cfg.d_inner,
             weight_dtype="int8 out_proj", by_batch=by_batch["out_proj"],
             yardstick_note="qmatmul(ya, q, scale): K7, the port's int8 product over all of K "
                            "(a bf16 result; the phase writes each K split's fp32 partial); "
                            "torch.matmul(ya, q as bf16): a bf16 product of the same shape, twice "
                            "the weight bytes; neither computes the phase's function, so "
                            "library_ms stays null"),
    )


def out_proj_phase(gen, layers, cfg, lcfg, task):
    """K4's bf16 out_proj phase (the gated, weighted yf times W_out into the
    fp32 K-split partials) of one layer alone, as the step launches it
    (`fused_decode_out_proj`), at 16, 48 and 96 rows: device ms beside the
    bytes it must move at the card's memory rate, and `torch.matmul(ya,
    W_out)` on the same bf16 operands (one PyTorch call for the same product,
    summed over all of K and rounded to bf16 where the phase writes each K
    split's fp32 partial: the yardstick of the product). Each launch takes
    the next of the 48 layers, so its weights come from device memory; the
    `_same_layer` times repeat one layer. `ms` is the mean of launches back
    to back, where each launch, a programmatic dependent of the one before,
    starts fetching weights while that one runs; `ms_alone` and
    `library_ms_alone` time each launch with nothing beside it
    (`time_alone_ms`): one kernel against one library call. Beside them the
    phase inside the 48-layer step (profile of 3 steps): each kernel's time
    and the part of it that no earlier kernel overlaps, all of the
    out_proj's the pair kernel's."""
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_out_proj, fused_decode_step, prepare_fused_decode)

    bf = torch.bfloat16
    by_batch = {}
    for b in (16, BATCH, 2 * BATCH):
        h = rand(gen, (b, cfg.d_model), bf)
        cache = fused_state(gen, len(layers), b, cfg, bf, bf)
        plan = prepare_fused_decode(layers, task, cfg, lcfg, b, bf)
        args = (layers, h, None, cache, task, cfg, lcfg, 1e-5)
        fused_decode_step(*args, plan=plan)  # the scratch holds a real yf * w_gn
        w_out = [layer["mixer"]["out_proj"]["kernel"] for layer in layers]
        ya, turn = plan.scratch["ya"], [0]

        def phase():
            fused_decode_out_proj(*args, plan=plan, layer=turn[0] % len(layers))
            turn[0] += 1

        def product():
            torch.matmul(ya, w_out[turn[0] % len(layers)])
            turn[0] += 1

        phase_bytes = k4_phase_bytes(cfg, lcfg.r, b)["k4_out_proj"]
        ms = time_ms(phase, 2 * len(layers))
        prof = profile_steps(lambda i: fused_decode_step(*args, plan=plan), 3,
                             named=K4_PHASES + ("k4_out_proj_pair",))
        bound = phase_bytes / HBM_BYTES_PER_S * 1e3
        by_batch[f"B{b}"] = {
            "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms, "bytes": phase_bytes,
            "library_ms": time_ms(product, 2 * len(layers)),
            "ms_alone": time_alone_ms(phase, 2 * len(layers)),
            "library_ms_alone": time_alone_ms(product, 2 * len(layers)),
            "ms_same_layer": time_ms(lambda: fused_decode_out_proj(*args, plan=plan, layer=0), 20),
            "library_ms_same_layer": time_ms(lambda: torch.matmul(ya, w_out[0]), 20),
            "step_ms_per_layer": {k: v / len(layers) for k, v in prof["named_ms_per_step"].items()},
            "step_exposed_ms_per_layer": {
                k: v / len(layers) for k, v in prof["named_exposed_ms_per_step"].items()},
            "step_device_busy_ms": prof["device_busy_ms_per_step"],
        }
        # the step's out_proj time is the pair kernel's, and only its
        named = prof["named_ms_per_step"]
        assert 0 < named["k4_out_proj_pair"] == named["k4_out_proj"], by_batch[f"B{b}"]
        del cache, plan
    return {"kernel": "decode_fused", "case": "out_proj_phase", "layers": 1, "d_model": cfg.d_model,
            "d_inner": cfg.d_inner, "dtype": str(bf), "by_batch": by_batch,
            "library_note": "torch.matmul(ya, W_out) on the same bf16 operands: the same product "
                            "in one call (summed over all of K, a bf16 result), the yardstick "
                            "for the phase, which writes each K split's fp32 partial"}


def ssm_phase(gen, layers, cfg, lcfg, task):
    """K4's SSM-update phase (the state update in place, y, the gate, yf * w_gn
    and the sums of yf^2) of one layer alone, as the step launches it
    (`fused_decode_ssm`), at 16, 48 and 96 rows with a bf16 state and at 16
    rows with an fp32 state: device ms beside the bytes it must move at the
    card's memory rate, and beside a device copy of the same state bytes
    (`copy_` of one layer's state into another tensor: what a stream that reads
    and writes each byte once reaches on this card; it does not compute the
    phase's function). Each launch takes the next of the 48 layers, so the
    state comes from device memory. Beside them the phase inside the 48-layer
    step (profile of 3 steps): each kernel's time and the part of it that no
    earlier kernel overlaps."""
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_ssm, fused_decode_step, prepare_fused_decode)

    bf = torch.bfloat16
    by_case = {}
    for b, sdtype in ((16, bf), (BATCH, bf), (2 * BATCH, bf), (16, torch.float32)):
        h = rand(gen, (b, cfg.d_model), bf)
        cache = fused_state(gen, len(layers), b, cfg, bf, sdtype)
        plan = prepare_fused_decode(layers, task, cfg, lcfg, b, bf)
        args = (layers, h, None, cache, task, cfg, lcfg, 1e-5)
        fused_decode_step(*args, plan=plan)  # the scratch holds a real z, x B C and dt
        states, turn = cache.ssm_state, [0]
        copy_to = torch.empty_like(states[0])

        def phase():
            fused_decode_ssm(*args, plan=plan, layer=turn[0] % len(layers))
            turn[0] += 1

        def copy():
            copy_to.copy_(states[turn[0] % len(layers)])
            turn[0] += 1

        phase_bytes = k4_phase_bytes(cfg, lcfg.r, b, state_bytes=states.element_size())["k4_ssm"]
        ms = time_ms(phase, 2 * len(layers))
        copy_ms = time_ms(copy, 2 * len(layers))
        prof = profile_steps(lambda i: fused_decode_step(*args, plan=plan), 3, named=K4_PHASES)
        bound = phase_bytes / HBM_BYTES_PER_S * 1e3
        copy_bytes = 2 * nbytes(states[0])
        by_case[f"B{b}_{'bf16' if sdtype == bf else 'fp32'}_state"] = {
            "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms, "bytes": phase_bytes,
            "rate_tb_per_s": phase_bytes / ms / 1e9,
            "copy_ms": copy_ms, "copy_bytes": copy_bytes,
            "copy_rate_tb_per_s": copy_bytes / copy_ms / 1e9,
            "step_ms_per_layer": {k: v / len(layers) for k, v in prof["named_ms_per_step"].items()},
            "step_exposed_ms_per_layer": {
                k: v / len(layers) for k, v in prof["named_exposed_ms_per_step"].items()},
            "step_device_busy_ms": prof["device_busy_ms_per_step"],
        }
        del cache, plan, states, copy_to
    return {"kernel": "decode_fused", "case": "ssm_phase", "layers": 1, "d_model": cfg.d_model,
            "heads": cfg.nheads, "head_dim": cfg.headdim, "d_state": cfg.d_state, "dtype": str(bf),
            "by_case": by_case,
            "copy_note": "copy_ of one layer's state into another tensor (each byte read and "
                         "written once): the rate a read-write stream reaches, not the phase's "
                         "function, so library_ms stays null"}


def step_pair_ms(gen, layers, cfg, lcfg, B, io, sdtype):
    """One token step through `layers` by the whole-model kernel and by the
    layer loop (`block_step`, which the "scan" decode path runs): milliseconds
    of device work and on the host's clock, same weights and state shapes."""
    from omnimamba_tpu_torch.models.blocks import block_step
    from omnimamba_tpu_torch.models.mamba2 import Mamba2Cache
    from omnimamba_tpu_torch.ops.decode_fused import fused_decode_step, prepare_fused_decode

    h = rand(gen, (B, cfg.d_model), io)
    cache = fused_state(gen, len(layers), B, cfg, io, sdtype)
    plan = prepare_fused_decode(layers, "t2i", cfg, lcfg, B, io)

    def fused():
        fused_decode_step(layers, h, None, cache, "t2i", cfg, lcfg, 1e-5, plan=plan)

    def scan():
        hh, res = h, None
        for i, layer in enumerate(layers):
            hh, res, _ = block_step(
                layer, hh, res, Mamba2Cache(cache.conv_state[i], cache.ssm_state[i]), "t2i",
                cfg, lcfg, norm_eps=1e-5)

    # the loop's 1,372 launches a step overflow the launch queue, so its device
    # time cannot be read behind queued work: the profiler's summed kernel time
    return {"batch": B, "dtype": str(io), "state_dtype": str(sdtype),
            "fused_device_ms": time_ms(fused, 5), "fused_host_clock_ms": host_clock_ms(fused, 5),
            "scan_device_busy_ms": profile_steps(lambda i: scan(), 2)["device_busy_ms_per_step"],
            "scan_host_clock_ms": host_clock_ms(scan, 5)}


class _Count:
    """One kernel's launch counter: the attribute `attr` of its wrapper (the
    int8 branches of K4 and K2 count on their wrappers' `int8_launches`)."""

    def __init__(self, fn, attr="launches"):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


def kernel_wrappers():
    from omnimamba_tpu_torch.ops.decode_fused import fused_decode_step
    from omnimamba_tpu_torch.ops.norms_kernel import (
        fused_add_rms_norm, fused_add_rms_norm_bwd, fused_gated_rms_norm, fused_gated_rms_norm_bwd)
    from omnimamba_tpu_torch.ops.quant_kernel import qmatmul
    from omnimamba_tpu_torch.ops.ssd_kernel import ssd_fused, ssd_fused_bwd
    from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused

    fns = {
        "ssd_scan": ssd_fused, "ssd_step": ssd_step_fused,
        "add_rms_norm": fused_add_rms_norm, "gated_rms_norm": fused_gated_rms_norm,
        "decode_fused": fused_decode_step,
        "ssd_scan_bwd": ssd_fused_bwd, "add_rms_norm_bwd": fused_add_rms_norm_bwd,
        "gated_rms_norm_bwd": fused_gated_rms_norm_bwd, "qmatmul": qmatmul,
    }
    counts = {k: _Count(fn) for k, fn in fns.items()}
    counts["decode_fused_int8"] = _Count(fused_decode_step, "int8_launches")
    counts["ssd_step_int8"] = _Count(ssd_step_fused, "int8_launches")
    return counts


BACKWARD_KERNELS = ("ssd_scan_bwd", "add_rms_norm_bwd", "gated_rms_norm_bwd")  # training only
INT8_KERNELS = ("qmatmul", "decode_fused_int8", "ssd_step_int8")  # int8 weights or state only


KERNEL_FILES = {
    "ssd_scan": ("omnimamba_tpu_torch/csrc/ssd_scan.cu", "omnimamba_tpu/ops/ssd_pallas.py:310"),
    "ssd_step": ("omnimamba_tpu_torch/csrc/ssd_step.cu", "omnimamba_tpu/ops/ssd_step_pallas.py:98"),
    "add_rms_norm": ("omnimamba_tpu_torch/csrc/norms.cu", "omnimamba_tpu/ops/norms_pallas.py:129"),
    "gated_rms_norm": ("omnimamba_tpu_torch/csrc/norms.cu", "omnimamba_tpu/ops/norms_pallas.py:280"),
    "decode_fused": ("omnimamba_tpu_torch/csrc/decode_fused.cu", "omnimamba_tpu/ops/decode_fused.py:447"),
    "ssd_scan_bwd": ("omnimamba_tpu_torch/csrc/ssd_scan_bwd.cu", "omnimamba_tpu/ops/ssd_pallas_bwd.py:416"),
    "add_rms_norm_bwd": ("omnimamba_tpu_torch/csrc/norms.cu", "omnimamba_tpu/ops/norms_pallas.py:200"),
    "gated_rms_norm_bwd": ("omnimamba_tpu_torch/csrc/norms.cu", "omnimamba_tpu/ops/norms_pallas.py:307"),
    "qmatmul": ("omnimamba_tpu_torch/csrc/qmatmul.cu", "omnimamba_tpu/ops/quant_pallas.py:71"),
    # the int8 {q, scale} branch of the whole-model step (_mm with quant=True)
    "decode_fused_int8": ("omnimamba_tpu_torch/csrc/decode_fused.cu",
                          "omnimamba_tpu/ops/decode_fused.py:72"),
    # the scaled-int8 state step: XLA code on the TPU side, no Pallas kernel
    "ssd_step_int8": ("omnimamba_tpu_torch/csrc/ssd_step.cu", "omnimamba_tpu/ops/ssd_reference.py:118"),
}


# ---------------------------------------------------------------------------
# phase: the int8 kernels against their plain versions
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _m_tile(rows):
    """K7's bf16 activations take the 128-row tiles from `rows` rows on while
    inside (1: always; 2**30: never, the decode path)."""
    from omnimamba_tpu_torch.ops import quant_kernel

    saved, quant_kernel.M_TILE = quant_kernel.M_TILE, rows
    try:
        yield
    finally:
        quant_kernel.M_TILE = saved


def check_qmatmul(gen, results):
    """K7 in both layouts at every shape of the int8 main path (the 1.3B's
    prefill and step projections at batch 48, project_in, the image head, the
    slot engine's prefill group of 16 x 64 rows) and at awkward ones: one row,
    13 rows, O = 139, K = 24, fp32 activations, and K = 192 or 2112, where the
    decode path's last stage holds fewer k tiles than the others, in each of
    its column tiles. Rows 0-47 and row 0 of the prefill shapes, and rows 0-15
    and row 0 of four decode shapes and of the short-stage cases, must have
    the same bits alone as in the whole batch; the two tensor-core paths (the
    decode path's block pairs, the 128-row tiles) are timed against each other
    from 1 to 3456 rows, where they must give the same bits. A 48-row time is
    the median of five; its kernel_check line names the decode path's launch."""
    from omnimamba_tpu_torch.ops.quant import quantize_linear
    from omnimamba_tpu_torch.ops.quant_kernel import M_TILE, decode_plan, qmatmul, qmatmul_plain

    bf, f32 = torch.bfloat16, torch.float32
    rows = BATCH * PROMPT  # prefill rows
    cases = [
        # name, M, K, O, transposed table, x dtype, out dtype, timed
        ("step_in_proj", BATCH, 2048, 8512, False, bf, bf, True),
        ("prefill_in_proj", rows, 2048, 8512, False, bf, bf, True),
        ("prefill_out_proj", rows, 4096, 2048, False, bf, bf, True),
        ("slot_prefill_in_proj", 16 * 64, 2048, 8512, False, bf, bf, True),
        ("prefill_head_table", rows, 2048, 16384, True, bf, f32, True),
        ("step_out_proj", BATCH, 4096, 2048, False, bf, bf, True),
        ("project_in_fc1", BATCH, 2048, 8192, False, bf, bf, True),
        ("project_in_fc2", BATCH, 8192, 2048, False, bf, bf, True),
        ("project_in_fc3", BATCH, 2048, 2048, False, bf, bf, True),
        ("image_head", BATCH, 2048, 16384, True, bf, f32, True),
        ("one_row", 1, 2048, 8512, False, bf, bf, False),
        ("thirteen_rows_head", 13, 2048, 16384, True, bf, f32, False),
        ("twenty_rows_table_bf16", 20, 2048, 4096, True, bf, bf, False),
        # the decode path's last stage short of whole (K not a multiple of a stage's
        # k tiles), in each column tile (32, 64, 128 columns) and layout
        ("short_stage_32_columns", 48, 2112, 2048, False, bf, bf, False),
        ("short_stage_32_columns_table", 20, 2112, 2048, True, bf, bf, False),
        ("short_stage_64_columns", 20, 192, 8192, False, bf, bf, False),
        ("short_stage_64_columns_table", 48, 192, 8192, True, bf, f32, False),
        ("short_stage_128_columns", 64, 192, 16384, False, bf, bf, False),
        ("short_stage_128_columns_table", 48, 192, 16384, True, bf, f32, False),
        ("awkward", 13, 24, 139, False, f32, f32, False),
        ("awkward_bf16_table", 13, 24, 139, True, bf, bf, False),
        ("ragged_columns_bf16", 5, 2048, 139, False, bf, bf, False),
        ("fp32_step_in_proj", BATCH, 2048, 8512, False, f32, f32, False),
        ("fp32_table", 4, 2048, 16384, True, f32, f32, False),
    ]
    shapes, worst = {}, 0.0
    for name, M, K, O, tr, xd, od, timed in cases:
        w = rand(gen, (O, K) if tr else (K, O), f32, 0.02)
        qe = quantize_linear(w, (1,) if tr else (0,))
        q, sc = qe["q"], qe["scale"]
        x = rand(gen, (M, K), xd)
        y = qmatmul(x, q, sc, tr, od)
        torch.cuda.synchronize()
        y_ref = qmatmul_plain(x, q, sc, tr, od)
        err, share = errors(y, y_ref)
        worst = max(worst, err)
        rec = {"kernel": "qmatmul", "case": name, "shape": (M, K, O), "layout": "(O, K)" if tr else "(K, O)",
               "dtype": str(xd), "out_dtype": str(od), "abs_err": err, "err_of_allowed": share,
               "rtol": RTOL[od], "atol_rel": ATOL_REL}
        assert share <= 1.0, rec
        decode = xd == bf and M < M_TILE and K % 64 == 0 and O % 64 == 0
        if decode:
            rec["decode_plan"] = plan = decode_plan(M, O, tr)
            if name.startswith("short_stage_"):  # the case reaches the branch it is for
                assert (plan["columns"] == int(name.split("_")[2])
                        and K // 64 % plan["stage_tiles"] != 0), rec
        # a row's bits alone and in the batch: rows 0-47 across M_TILE at prefill,
        # rows 0-15 inside the decode path
        alone = {"prefill_in_proj": BATCH, "prefill_out_proj": BATCH, "prefill_head_table": BATCH,
                 "step_in_proj": 16, "step_out_proj": 16, "project_in_fc2": 16, "image_head": 16}
        if name in alone or name.startswith("short_stage_"):
            n = alone.get(name, 16)
            rec["rows_alone_identical"] = (torch.equal(y[:n], qmatmul(x[:n], q, sc, tr, od))
                                           and torch.equal(y[:1], qmatmul(x[:1], q, sc, tr, od)))
            assert rec["rows_alone_identical"], rec
        if timed:
            moved = nbytes(x, q, sc, y)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * M * K * O / PEAK_OPS[xd] * 1e3
            iters = 5 if M > BATCH else 20
            dense = w.to(xd)  # yardstick: a dense weight of the same shape in x's type

            def timed_ms(fn):
                # a 48-row time is a few microseconds: the median of five runs
                if M > BATCH:
                    return time_ms(fn, iters), None
                runs = [time_ms(fn, iters) for _ in range(5)]
                return statistics.median(runs), runs

            ms, ms_runs = timed_ms(lambda: qmatmul(x, q, sc, tr, od))
            library_ms, library_runs = timed_ms(lambda: torch.matmul(x, dense.T if tr else dense))
            rec.update(
                ms=ms,
                plain_ms=time_ms(lambda: qmatmul_plain(x, q, sc, tr, od), 3, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved,
                library_ms=library_ms,
                library_note="torch.matmul on a dense weight of the same shape in x's type: a "
                             "yardstick, not the same function (it reads twice the weight bytes)",
            )
            if ms_runs:
                rec.update(ms_runs=ms_runs, library_ms_runs=library_runs)
            shapes[name] = {k: rec[k] for k in ("shape", "layout", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}
            if name == "step_in_proj":
                results["qmatmul"] = dict(rec)
        emit({"kernel_check": rec})
        del w, qe, q, sc, x, y, y_ref

    # the two paths on one layer's prefill products (in_proj, out_proj) at each M
    weights = {}
    for name, K, O in (("in_proj", 2048, 8512), ("out_proj", 4096, 2048)):
        qe = quantize_linear(rand(gen, (K, O), f32, 0.02), (0,))
        weights[name] = (K, qe["q"], qe["scale"])
    sweep = []
    for M in (1, 16, BATCH, 64, 127, 128, 256, 1024, rows):
        rec = {"rows": M}
        for name, (K, q, sc) in weights.items():
            x = rand(gen, (M, K), bf)
            ys = {}
            for path, m_tile in (("decode", 2 ** 30), ("tiles_128", 1)):
                with _m_tile(m_tile):
                    ys[path] = qmatmul(x, q, sc)
                    rec[f"{name}_{path}_ms"] = time_ms(lambda: qmatmul(x, q, sc), 5 if M > BATCH else 20)
            assert torch.equal(ys["decode"], ys["tiles_128"]), (name, M)
        for path in ("decode", "tiles_128"):
            rec[f"layer_{path}_ms"] = rec[f"in_proj_{path}_ms"] + rec[f"out_proj_{path}_ms"]
        sweep.append(rec)
    del weights, x, ys
    emit({"qmatmul_m_sweep": {
        "m_tile": M_TILE, "sweep": sweep,
        "note": "device ms of K7's two tensor-core paths (the decode path's block pairs, the "
                "128-row tiles) on the same inputs: in_proj 2048 x 8512 and out_proj 4096 x 2048, "
                "(K, O), bf16; the two gave the same bits at every M"}})
    results["qmatmul"].update(max_abs_err=worst, shapes=shapes, m_tile=M_TILE, m_sweep=sweep)


def check_decode_fused_int8(gen, results):
    """K4's int8 branch (int8 in_proj and out_proj, the other weights in the
    activation type) against its plain version at 1 and 48 layers, batch 48
    and 4, bf16 and fp32, at one bf16 layer at the pair kernels' row tiles
    (17, 96 and 112 rows), and at one bf16 layer of the out_proj's two- and
    three-split layouts, with K4's tolerances (see BF16_STEP_ATOL_REL and
    DEEP_TOL_REL); which in_proj and out_proj kernel each case ran, by name;
    rows 0-2 of two bf16 steps against the 3-row step, bit for bit; the int8
    in_proj and out_proj phases alone (`int8_phases`) and the int8 step by
    phase."""
    from omnimamba_tpu_torch.config import LoraConfig, Mamba2LayerConfig
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_step, fused_decode_step_plain, prepare_fused_decode)
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params

    full, lora8 = Mamba2LayerConfig(), LoraConfig()
    narrow = Mamba2LayerConfig(d_model=24, d_state=20, headdim=16, d_conv=3)
    # the out_proj's K-split layouts that the 1.3B (four splits of 1,024) does
    # not reach, all widths multiples of 64: d_inner 2,048 in two splits, and
    # 2,560 in three of 896, 896 and a short 768 (in_proj width 5,440)
    d1024 = Mamba2LayerConfig(d_model=1024, headdim=32)
    d1280 = Mamba2LayerConfig(d_model=1280, headdim=40)
    bf, f32 = torch.bfloat16, torch.float32
    sizes = {"bf16": (48, full, lora8, bf), "f32": (48, full, lora8, f32),
             "narrow_f32": (2, narrow, LoraConfig(r=4), f32),
             "narrow_bf16": (2, narrow, LoraConfig(r=4), bf),
             "d1024_bf16": (1, d1024, lora8, bf), "d1280_bf16": (1, d1280, lora8, bf)}
    stacks = {}

    def stack(name):
        if name not in stacks:
            layers = fused_layers(gen, *sizes[name])
            stacks[name] = quantize_decode_params({"layers": layers})["layers"]
            del layers
        return stacks[name]

    cases = [
        # name, stack, layers used, B, mixer cfg, lora cfg, task, io, state
        ("int8_1_layer", "bf16", 1, BATCH, full, lora8, "t2i", bf, bf),
        ("int8_1_layer_four_rows", "bf16", 1, 4, full, lora8, "mmu", bf, f32),
        ("int8_deep_four_rows", "bf16", 48, 4, full, lora8, "t2i", bf, bf),
        ("int8_awkward", "narrow_f32", 2, 3, narrow, LoraConfig(r=4), "t2i", f32, f32),
        ("int8_awkward_bf16", "narrow_bf16", 2, 5, narrow, LoraConfig(r=4), "mmu", bf, bf),
        ("int8_main", "bf16", 48, BATCH, full, lora8, "t2i", bf, bf),
        # the int8 in_proj's row tiles: a partial second m16 fragment, one tile
        # of 96 rows (without LoRA), two tiles
        ("int8_1_layer_17_rows", "bf16", 1, 17, full, lora8, "mmu", bf, bf),
        ("int8_1_layer_96_rows", "bf16", 1, 2 * BATCH, full, lora8, None, bf, bf),
        ("int8_1_layer_112_rows", "bf16", 1, 112, full, lora8, "t2i", bf, f32),
        ("int8_d_model_1024", "d1024_bf16", 1, BATCH, d1024, lora8, "t2i", bf, bf),
        ("int8_d_model_1280", "d1280_bf16", 1, BATCH, d1280, lora8, "mmu", bf, bf),
        ("int8_fp32_1_layer", "f32", 1, BATCH, full, lora8, "t2i", f32, f32),
        ("int8_fp32_1_layer_four_rows", "f32", 1, 4, full, lora8, "mmu", f32, bf),
        ("int8_fp32_deep_four_rows", "f32", 48, 4, full, lora8, "t2i", f32, f32),
    ]
    # the in_proj kernel each case must run (by name): on whole tiles the pair
    # kernel of int8 weights with MT m16 row fragments a block (six from B=96
    # on: one row tile at 96, two at 112); elsewhere the multiply-add kernel
    in_proj_of = {"int8_1_layer": "k4_in_proj_pair_kernel<3, signed char>",
                  "int8_1_layer_four_rows": "k4_in_proj_pair_kernel<1, signed char>",
                  "int8_1_layer_17_rows": "k4_in_proj_pair_kernel<2, signed char>",
                  "int8_1_layer_96_rows": "k4_in_proj_pair_kernel<6, signed char>",
                  "int8_1_layer_112_rows": "k4_in_proj_pair_kernel<6, signed char>",
                  "int8_awkward": "k4_in_proj_kernel<float, float, signed char>",
                  "int8_awkward_bf16": "k4_in_proj_kernel<__nv_bfloat16, __nv_bfloat16, signed char>"}
    # the out_proj kernel each case must run (by name): on whole tiles the pair
    # kernel of int8 weights with the in_proj's row fragments; elsewhere the
    # multiply-add kernel
    out_proj_of = {"int8_1_layer": "k4_out_proj_pair_kernel<3, signed char>",
                   "int8_1_layer_four_rows": "k4_out_proj_pair_kernel<1, signed char>",
                   "int8_1_layer_17_rows": "k4_out_proj_pair_kernel<2, signed char>",
                   "int8_1_layer_96_rows": "k4_out_proj_pair_kernel<6, signed char>",
                   "int8_1_layer_112_rows": "k4_out_proj_pair_kernel<6, signed char>",
                   "int8_d_model_1024": "k4_out_proj_pair_kernel<3, signed char>",
                   "int8_d_model_1280": "k4_out_proj_pair_kernel<3, signed char>",
                   "int8_awkward": "k4_out_proj_kernel<float, signed char>",
                   "int8_awkward_bf16": "k4_out_proj_kernel<__nv_bfloat16, signed char>"}
    # the int8 in_proj and out_proj alone, beside their bounds and two
    # yardsticks of each product
    phase_recs = int8_phases(gen, stack("bf16"), full, lora8, "t2i")
    for phase_rec in phase_recs:
        emit({"kernel_check": phase_rec})
    for name, sname, n_layer, B, cfg, lcfg, task, io, sdtype in cases:
        if sname == "f32" and "bf16" in stacks:
            stacks.pop("bf16")
            torch.cuda.empty_cache()
        layers = stack(sname)[:n_layer]
        cache0 = fused_state(gen, n_layer, B, cfg, io, sdtype)
        h = rand(gen, (B, cfg.d_model), io)
        residual = rand(gen, (B, cfg.d_model), f32) if name != "int8_main" else None
        args = (task, cfg, lcfg, 1e-5)
        ref_cache = cache0._replace(conv_state=cache0.conv_state.clone(),
                                    ssm_state=cache0.ssm_state.clone())
        h_ref, res_ref, _ = fused_decode_step_plain(layers, h, residual, ref_cache, *args)
        cache = cache0._replace(conv_state=cache0.conv_state.clone(), ssm_state=cache0.ssm_state.clone())
        plan = prepare_fused_decode(layers, task, cfg, lcfg, B, io)
        assert plan.proj_dtype == torch.int8
        h_out, res_out, _ = fused_decode_step(layers, h, residual, cache, *args, plan=plan)
        torch.cuda.synchronize()
        pairs = {"h": (h_out, h_ref), "residual": (res_out, res_ref),
                 "conv_window": (cache.conv_state, ref_cache.conv_state),
                 "ssm_state": (cache.ssm_state, ref_cache.ssm_state)}
        rec = {"kernel": "decode_fused_int8", "case": name, "layers": n_layer, "batch": B,
               "d_model": cfg.d_model, "task": task, "dtype": str(io), "weight_dtype": "int8 projections",
               "state_dtype": str(sdtype)}
        deep = n_layer > 4
        worst = 0.0
        atol_rel = ATOL_REL if io == f32 else BF16_STEP_ATOL_REL
        for key, (got, want) in pairs.items():
            abs_err, share = errors(got, want, atol_rel)
            rec[f"{key}_abs_err"] = abs_err
            if deep:
                scale = want.float().abs().max().item()
                diff = (got.float() - want.float()).abs()
                share = abs_err / (DEEP_TOL_REL * scale)
                rec[f"{key}_mean_err_of_allowed"] = diff.mean().item() / (0.1 * DEEP_TOL_REL * scale)
                assert rec[f"{key}_mean_err_of_allowed"] <= 1.0, rec
            rec[f"{key}_err_of_allowed"] = share
            worst = max(worst, abs_err)
        rec.update({"tolerance": f"max and mean against {DEEP_TOL_REL} and {0.1 * DEEP_TOL_REL} "
                                 "of the largest reference value"} if deep else
                   {"rtol": {"fp32": 0.0, "bf16": RTOL[bf]}, "atol_rel": atol_rel})
        assert all(rec[f"{k}_err_of_allowed"] <= 1.0 for k in pairs), rec
        if name in ("int8_1_layer", "int8_1_layer_17_rows"):
            # a row's bits do not depend on the batch: rows 0-2 of this step
            # equal the 3-row step on the same rows, weights, residual and cache rows
            c3 = cache0._replace(conv_state=cache0.conv_state[:, :3].clone(),
                                 ssm_state=cache0.ssm_state[:, :3].clone())
            h3, r3, _ = fused_decode_step(
                layers, h[:3].contiguous(), residual[:3].contiguous(), c3, *args,
                plan=prepare_fused_decode(layers, task, cfg, lcfg, 3, io))
            torch.cuda.synchronize()
            same = {"h": torch.equal(h3, h_out[:3]), "residual": torch.equal(r3, res_out[:3]),
                    "conv_window": torch.equal(c3.conv_state, cache.conv_state[:, :3]),
                    "ssm_state": torch.equal(c3.ssm_state, cache.ssm_state[:, :3])}
            rec["rows_0_to_2_equal_to_3_row_step"] = same
            assert all(same.values()), rec
        if name in in_proj_of or name in out_proj_of:
            names = kernel_names(lambda: fused_decode_step(
                layers, h, residual, cache, *args, plan=plan))
            for key, of in (("in_proj", in_proj_of), ("out_proj", out_proj_of)):
                if name not in of:
                    continue
                ran = [k for k in names if f"k4_{key}" in k]
                rec[f"{key}_kernels"] = ran
                want = of[name].replace(" ", "")
                assert ran and all(want in k.replace(" ", "") for k in ran), (name, ran)
        if name == "int8_main":
            moved = fused_step_bytes(layers, cache, h, task)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            flops = fused_step_flops(B, n_layer, cfg, lcfg.r)
            ops_ms = flops / PEAK_OPS[io] * 1e3

            def kernel_step():
                fused_decode_step(layers, h, residual, cache, *args, plan=plan)

            rec.update(
                ms=time_ms(kernel_step, 10), host_us=host_us(kernel_step, 20),
                plain_ms=time_ms(lambda: fused_decode_step_plain(
                    layers, h, residual, ref_cache, *args), 2, 1),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, flops=flops, library_ms=None,
                library_note="no single PyTorch call computes a whole-model decode step",
            )
            # device time per kernel of the int8 step at the main batch
            rec["profile"] = profile_steps(
                lambda i: fused_decode_step(layers, h, None, cache, *args, plan=plan), 3,
                named=K4_PHASES)
            # the int8 step by phase, beside each phase's bytes (int8 projections)
            rec["k4_phases"] = k4_phase_split(
                rec["profile"], types.SimpleNamespace(mixer=cfg, lora=lcfg, n_layer=n_layer), B,
                proj_bytes=1)
            results["decode_fused_int8"] = dict(rec, max_abs_err=worst, shape=(n_layer, B, cfg.d_model))
        emit({"kernel_check": rec})
        del cache0, cache, ref_cache, plan
    for phase_rec in phase_recs:
        results["decode_fused_int8"][phase_rec["case"]] = {"by_batch": phase_rec["by_batch"]}
    stacks.clear()
    torch.cuda.empty_cache()


# q of the int8-state step. Kernel and plain version compute s' = s * decay +
# dtx * B with one rounding fewer in the kernel (it contracts the multiply-add),
# then the row's scale ns = amax|s'| / 127 + 1e-20 and s' / ns, each correctly
# rounded in both. With u = 2^-24 and mag = |s * decay| + |dtx * B| (the sum
# can cancel), s' differs by at most 3u mag, ns by 3u max(mag) / amax + 2u
# relative, and the quotient v by u (3 mag / ns + |v| (3 max(mag) / amax + 4)).
# q may round apart only where v lies that close to a .5 boundary; the window
# takes Q8_ULPS = 8 in place of 3 and 4, twice the bound. Elsewhere q is equal.
Q8_ULPS = 8


def q8_tie_window(state0, x, dt, A, Bm, unrounded, scale):
    """Per element of q (B, H, P, N), the distance from .5 (in units of q)
    within which kernel and plain version may round apart."""
    from omnimamba_tpu_torch.ops.quant import dequantize_ssm_state

    H, G = x.shape[1], Bm.shape[1]
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())[..., None, None]
    dtx = (dtf[..., None] * x.float())[..., None]
    Bf = Bm.float().repeat_interleave(H // G, dim=1)[:, :, None, :]
    mag = (dequantize_ssm_state(state0) * decay).abs() + (dtx * Bf).abs()
    ns = scale[..., None]
    amax = unrounded.abs().amax(-1, keepdim=True)
    v = (unrounded / ns).abs()
    rel = mag.amax(-1, keepdim=True) / torch.clamp(amax, min=1e-30)
    return Q8_ULPS * 2.0 ** -24 * (mag / ns + v * (rel + 1.0))


@contextlib.contextmanager
def only(entry: str, fn):
    """The library's wrappers see `fn` as its function `entry`, and the shipped
    library's others, while inside."""
    from omnimamba_tpu_torch.ops import kernel_build as kb

    shipped, load = kb.load_kernels(), kb.load_kernels

    class _Only:
        def __getattr__(self, name):
            return fn if name == entry else getattr(shipped, name)

    kb.load_kernels = _Only
    try:
        yield
    finally:
        kb.load_kernels = load


def variant_entry(source: str, entry: str, macro: str, value: int):
    """`entry` of `source` (under csrc) built on its own with `macro` set to
    `value` (a measurement macro: the parent kernel of a shape, for one),
    with the shipped library's signature."""
    import ctypes

    from omnimamba_tpu_torch.ops import kernel_build as kb

    lib = kb.BUILD_DIR / "variants" / f"lib_{macro}_{value}_{kb._source_hash()}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([kb._find_nvcc(), *kb.NVCC_FLAGS, "-shared", f"-D{macro}={value}", "-o",
                        str(lib), str(kb.CSRC_DIR / source)], check=True, capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    shipped = getattr(kb.load_kernels(), entry)
    fn.argtypes, fn.restype = shipped.argtypes, shipped.restype
    return fn


def _bits(t):
    """A float tensor's bits as integers of its width (NaNs by their payload)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16) if t.is_floating_point() else t


def bits_equal(a, b) -> bool:
    """Equal bit for bit, NaNs by their payload."""
    return torch.equal(_bits(a), _bits(b))


# the K2 int8 kernels by profiler name: the tile kernel where q8_tile_fits(P, N)
# (P a multiple of 8 up to 64, N a multiple of 4 up to 128), the row kernel elsewhere
Q8_TILE, Q8_ROW = "ssd_step_q8_tile_kernel", "ssd_step_q8_kernel"
# layers' states a timed launch walks through, so that each reads q from device memory
STATE_LAYERS = 48


def q8_edge_inputs(gen):
    """Inputs whose new state holds the quotients where the requantize is
    easiest to get wrong, (8, 2, 8, 1, 128) fp32: A = 0 (decay 1), dt = 1 and
    the old q 0, so s' = x[p] B[n] exactly, x[p] = 2^e for e from -90 to 75
    (the new scale from 1e-20 to beyond the fast division's 2^72). Batch rows
    0-3: amax 127 m (the scale m, for m = 3, 5, 6.5, 0.375) and the rest
    m (k + 0.5) for random k, exactly at a rounding tie and one ulp to either
    side; 4: random; 5: zeros; 6: a NaN; 7: an infinity."""
    B, H, P, G, N = 8, 2, 8, 1, 128
    f32 = torch.float32
    Bm = rand(gen, (B, G, N), f32)
    for b, m in enumerate((3.0, 5.0, 6.5, 0.375)):
        k = torch.randint(-127, 127, (N,), generator=gen, device="cuda").float()
        tie = m * (k + 0.5)
        side = torch.randint(-1, 2, (N,), generator=gen, device="cuda")
        tie = torch.where(side > 0, torch.nextafter(tie, torch.full_like(tie, 1e30)),
                          torch.where(side < 0, torch.nextafter(tie, torch.full_like(tie, -1e30)), tie))
        tie[0] = 127.0 * m
        Bm[b, 0] = tie
    Bm[5] = 0.0
    Bm[6, 0, 5] = float("nan")
    Bm[7, 0, 9] = float("inf")
    e = torch.arange(H * P, device="cuda", dtype=f32).view(1, H, P) * 11.0 - 90.0
    x = torch.exp2(e).expand(B, H, P).contiguous()
    dt = torch.ones((B, H), device="cuda", dtype=f32)
    A = torch.zeros((H,), device="cuda", dtype=f32)
    Cm = rand(gen, (B, G, N), f32)
    D = rand(gen, (H,), f32)
    state0 = {"q": torch.zeros((B, H, P, N), dtype=torch.int8, device="cuda"),
              "scale": torch.ones((B, H, P), dtype=f32, device="cuda")}
    return x, dt, A, Bm, Cm, D, state0


def check_ssd_step_int8(gen, results):
    """K2's int8-state branch against the plain int8 step: y and the scale by
    the kernels' rule, q equal but for values within `q8_tie_window` of .5.
    Which kernel each case ran, by profiler name; where the tile kernel ran, q,
    scale and y against the row kernel (the parent kernel of those shapes,
    built with OMT_K2_Q8_SKIP=32) bit for bit, and at rows built to hit
    rounding ties, the range edges of the fast division and non-finite
    values. Timed cases: one state, and each launch on the next of 48 layers'
    states (q from device memory) beside the row kernel and a `copy_` of the
    same q and scale bytes."""
    from omnimamba_tpu_torch.ops.quant import dequantize_ssm_state, quantize_ssm_state
    from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused, ssd_step_plain

    bf, f32 = torch.bfloat16, torch.float32
    parent = variant_entry("ssd_step.cu", "omt_ssd_step_q8", "OMT_K2_Q8_SKIP", 32)
    cases = [
        # name, (B, H, P, G, N), x dtype, with D, timed
        ("main", (BATCH, 64, 64, 1, 128), bf, True, True),
        ("one_row", (1, 64, 64, 1, 128), bf, True, False),
        ("fp32", (BATCH, 64, 64, 1, 128), f32, True, False),
        ("awkward", (3, 6, 24, 2, 20), f32, False, False),
        ("b16", (16, 64, 64, 1, 128), bf, True, True),
        ("b96", (96, 64, 64, 1, 128), bf, True, True),
        ("n256", (2, 4, 16, 1, 256), f32, True, False),  # beyond the tile kernel
    ]
    for name, (B, H, P, G, N), dtype, with_d, timed in cases:
        x, dt, A, Bm, Cm, D = ssd_inputs(gen, B, 1, H, P, G, N, dtype, True)
        x, dt, Bm, Cm = x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0]
        if not with_d:
            D = None
        state0 = quantize_ssm_state(rand(gen, (B, H, P, N), f32, 0.5))
        y_ref, s_ref = ssd_step_plain(x, dt, A, Bm, Cm, D, state0)
        _, unrounded = ssd_step_plain(x, dt, A, Bm, Cm, D, dequantize_ssm_state(state0))
        state = {k: v.clone() for k, v in state0.items()}
        y, s = ssd_step_fused(x, dt, A, Bm, Cm, D, state)
        torch.cuda.synchronize()
        assert s is state, "the state must be updated in place"
        ey, ry = errors(y, y_ref)
        es, rs = errors(state["scale"], s_ref["scale"])
        value = unrounded / s_ref["scale"][..., None]
        from_tie = ((value - torch.floor(value)) - 0.5).abs()
        window = q8_tie_window(state0, x, dt, A, Bm, unrounded, s_ref["scale"])
        near = from_tie < window
        dq = (state["q"].int() - s_ref["q"].int()).abs()
        differ = dq > 0
        rec = {"kernel": "ssd_step_int8", "case": name, "shape": (B, H, P, G, N), "dtype": str(dtype),
               "state": "int8 q with an fp32 scale a (b, h, p) row",
               "y_abs_err": ey, "y_err_of_allowed": ry, "scale_abs_err": es,
               "scale_err_of_allowed": rs, "q_max_diff": int(dq.max()),
               "q_diffs": int(differ.sum()), "q_diffs_not_at_a_tie": int((differ & ~near).sum()),
               "q_tie_ulps": Q8_ULPS,
               "q_tie_window_median": float(window.median()), "q_tie_window_max": float(window.max()),
               "q_diff_largest_distance_from_tie": float(from_tie[differ].max()) if differ.any() else None,
               "q_diff_largest_share_of_window": (float((from_tie / window)[differ].max())
                                                  if differ.any() else None),
               "rtol": [RTOL[dtype], 0.0], "atol_rel": ATOL_REL}
        assert ry <= 1.0 and rs <= 1.0, rec
        assert rec["q_max_diff"] <= 1 and rec["q_diffs_not_at_a_tie"] == 0, rec
        scratch = {k: v.clone() for k, v in state0.items()}
        names = []
        for _ in range(3):  # seen once: three traces of a 64-block launch that held no kernel
            names = [n for n in kernel_names(lambda: ssd_step_fused(x, dt, A, Bm, Cm, D, scratch))
                     if "ssd_step_q8" in n]
            if names:
                break
        rec["kernel_name"] = names
        want = Q8_ROW if name == "n256" else Q8_TILE
        assert len(names) == 1 and want in names[0] and not (want == Q8_ROW and Q8_TILE in names[0]), rec
        if want == Q8_TILE:
            with only("omt_ssd_step_q8", parent):
                y_p, s_p = ssd_step_fused(x, dt, A, Bm, Cm, D, {k: v.clone() for k, v in state0.items()})
            rec["bits_equal_to_the_row_kernel"] = (bits_equal(y, y_p) and bits_equal(state["q"], s_p["q"])
                                                   and bits_equal(state["scale"], s_p["scale"]))
            assert rec["bits_equal_to_the_row_kernel"], rec
        if timed:
            moved = nbytes(x, dt, A, Bm, Cm, D, y) + 2 * nbytes(state0["q"], state0["scale"])
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 8 * B * H * P * N / PEAK_OPS[f32] * 1e3
            layers = [{k: v.clone() for k, v in state0.items()} for _ in range(STATE_LAYERS)]
            turn = iter(range(1 << 30))

            def step(launch=None):
                st = layers[next(turn) % STATE_LAYERS]
                if launch is None:
                    return ssd_step_fused(x, dt, A, Bm, Cm, D, st)
                with only("omt_ssd_step_q8", launch):
                    return ssd_step_fused(x, dt, A, Bm, Cm, D, st)

            def copy():
                i = next(turn)
                src, dst = layers[i % STATE_LAYERS], layers[(i + STATE_LAYERS // 2) % STATE_LAYERS]
                dst["q"].copy_(src["q"])
                dst["scale"].copy_(src["scale"])

            hbm = 2 * STATE_LAYERS
            rec.update(
                ms=time_ms(lambda: ssd_step_fused(x, dt, A, Bm, Cm, D, state), 50),
                ms_from_hbm=time_ms(step, hbm),
                row_kernel_ms_from_hbm=time_ms(lambda: step(parent), hbm),
                copy_ms_from_hbm=time_ms(copy, hbm),
                host_us=host_us(lambda: ssd_step_fused(x, dt, A, Bm, Cm, D, state)),
                plain_ms=time_ms(lambda: ssd_step_plain(x, dt, A, Bm, Cm, D, state0), 10),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_moved=moved, library_ms=None,
                library_note="none: copy_ms_from_hbm is a copy_ of the same q and scale bytes, "
                             "a yardstick of the bytes and not the function",
            )
            del layers
            if name == "main":
                results["ssd_step_int8"] = dict(rec, max_abs_err=max(ey, es))
        emit({"kernel_check": rec})

    # rows built to hit ties, the fast division's range edges and non-finite values:
    # the tile kernel against the row kernel, bit for bit
    x, dt, A, Bm, Cm, D, state0 = q8_edge_inputs(gen)
    s_t, s_r = ({k: v.clone() for k, v in state0.items()} for _ in range(2))
    y_t = ssd_step_fused(x, dt, A, Bm, Cm, D, s_t)[0]
    with only("omt_ssd_step_q8", parent):
        y_r = ssd_step_fused(x, dt, A, Bm, Cm, D, s_r)[0]
    torch.cuda.synchronize()
    rec = {"kernel": "ssd_step_int8", "case": "edges", "shape": tuple(state0["q"].shape[:3]) + (1, 128),
           "dtype": str(f32), "nonfinite_y_rows": int((~torch.isfinite(y_t)).sum()),
           "q_nonzero": int((s_t["q"] != 0).sum()),
           "bits_equal_to_the_row_kernel": (bits_equal(y_t, y_r) and bits_equal(s_t["q"], s_r["q"])
                                            and bits_equal(s_t["scale"], s_r["scale"]))}
    emit({"kernel_check": rec})
    assert rec["bits_equal_to_the_row_kernel"], rec


# ---------------------------------------------------------------------------
# phase: the main path
# ---------------------------------------------------------------------------


def main_path(results, card):
    """The 1.3B model at full width, depth and batch through both decode paths:
    `t2i_generate` (whose decode_impl="auto" takes the whole-model decode
    kernel) and the layer-by-layer path (`generate(decode_impl="scan")` plus
    the VQ decode). Each path runs with the launch counters set to 0 just
    before it and read just after."""
    from omnimamba_tpu_torch import (
        MambaConfig, OmniMambaModel, SampleParams, VQConfig, init_omnimamba, t2i_generate)
    from omnimamba_tpu_torch.models.backbone import caption_embed, embed_text
    from omnimamba_tpu_torch.models.generation import generate
    from omnimamba_tpu_torch.models.vq import vq_decode_code

    cfg, vq_cfg = MambaConfig(), VQConfig()  # 1.3B: d=2048, 48 layers; VQ-16
    model = OmniMambaModel(cfg=cfg, vq_cfg=vq_cfg, sptids={})
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.time()
    params = init_omnimamba(gen, model, torch.bfloat16, "cuda")
    mamba = params["mamba"]
    n_params = sum(t.numel() for t in _leaves(mamba))
    text_ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    init_s = time.time() - t0
    ids = torch.as_tensor(text_ids, device="cuda")
    greedy = SampleParams(top_k=1)

    def embed():
        emb = caption_embed(mamba, embed_text(mamba, ids, torch.bfloat16))
        return emb + mamba["pos_embed"][:, :PROMPT]

    def run(decode_impl, decode_image=True, token_callback=None):
        """(images, tokens, seconds). "fused" goes through t2i_generate."""
        torch.cuda.synchronize()
        t = time.time()
        if decode_impl == "fused" and token_callback is None:
            images, tokens = t2i_generate(params, model, text_ids, sample=greedy,
                                          decode_image=decode_image)
        else:
            out = generate(mamba, cfg, input_ids=ids, input_embeddings=embed(), task="t2i",
                           max_length=PROMPT + cfg.num_tokens, sample=greedy,
                           decode_impl=decode_impl, token_callback=token_callback)
            tokens = out.sequences[:, PROMPT:]
            images = vq_decode_code(params["vq"], tokens, vq_cfg) if decode_image else None
        torch.cuda.synchronize()
        return images, tokens, time.time() - t

    wrappers = kernel_wrappers()
    steps = cfg.num_tokens - 1  # the first token comes from the prefill logits
    prefill = {"ssd_scan": cfg.n_layer, "add_rms_norm": cfg.n_layer, "gated_rms_norm": cfg.n_layer}
    # generation differentiates nothing; bf16 weights and states launch no int8 branch
    no_backward = dict.fromkeys(BACKWARD_KERNELS + INT8_KERNELS, 0)
    expect = {
        "fused": dict(prefill, decode_fused=steps, ssd_step=0, **no_backward),
        "scan": {"ssd_scan": cfg.n_layer, "ssd_step": cfg.n_layer * steps,
                 "add_rms_norm": cfg.n_layer * (steps + 1),
                 "gated_rms_norm": cfg.n_layer * (steps + 1), "decode_fused": 0, **no_backward},
    }
    run("fused", decode_image=False)  # warm-up: builds nothing new, loads library and cuBLAS/cuDNN plans
    torch.cuda.reset_peak_memory_stats()
    launches, totals, report, tokens_by = {}, {}, {}, {}
    for path in ("fused", "scan"):
        for w in wrappers.values():
            w.launches = 0
        images, tokens, total_s = run(path)
        tokens_by[path] = tokens
        launches[path] = {k: w.launches for k, w in wrappers.items()}
        totals[path] = [total_s]
        ok_tokens = (tuple(tokens.shape) == (BATCH, cfg.num_tokens)
                     and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vqvae_vocab_size)
        ok_images = (tuple(images.shape) == (BATCH, 256, 256, 3)
                     and bool(torch.isfinite(images.float()).all()))
        report[path] = {
            "tokens_shape": list(tokens.shape), "images_shape": list(images.shape),
            "tokens_in_range": ok_tokens, "images_finite": ok_images,
            "distinct_tokens": int(torch.unique(tokens).numel()),
            "launches": launches[path], "launches_expected": expect[path],
        }
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    emit({"main_path": {
        "model": "OmniMamba-1.3B", "params": n_params, "n_layer": cfg.n_layer,
        "d_model": cfg.d_model, "batch": BATCH, "prompt": PROMPT, "init_s": init_s,
        "fused": report["fused"], "scan": report["scan"],
    }})
    for path in ("fused", "scan"):
        assert report[path]["tokens_in_range"] and report[path]["images_finite"], path
        assert launches[path] == expect[path], (path, launches[path], expect[path])
    for name in wrappers:
        if name in BACKWARD_KERNELS + INT8_KERNELS:
            continue  # their counts come from the training path and the int8 path
        # a kernel's count comes from the path that runs it at decode; the
        # prefill kernels run on both and report the layer-by-layer path's
        # count beside the fused path's
        own = "fused" if name == "decode_fused" else "scan"
        results[name]["launches"] = launches[own][name]
        results[name]["launches_fused_path"] = launches["fused"][name]

    # ---- times: the fused generation twice more (the spread inside one
    # call; the layer-by-layer path is timed once), a run without image
    # decode, then per path one run with a per-token host callback whose time
    # stamps give the prefill / decode-step split ----
    totals["fused"] += [run("fused")[2] for _ in range(2)]
    tokens_only_s = run("fused", decode_image=False)[2]
    split = {}
    for path in ("fused", "scan"):
        stamps = []
        torch.cuda.synchronize()
        t_start = time.time()
        run(path, decode_image=False, token_callback=lambda _tok: stamps.append(time.time()))
        step_ms = np.diff(np.asarray(stamps)) * 1e3
        split[path] = {
            "prefill_and_first_token_ms": (stamps[0] - t_start) * 1e3,
            "decode_step_ms_median": float(np.median(step_ms)),
            "decode_step_ms_p90": float(np.percentile(step_ms, 90)),
            "decode_steps": int(step_ms.size),
        }

    profiles = {path: profile_decode_steps(mamba, cfg, ids, embed(), path,
                                           named=K4_PHASES + ("k4_ssm_tile", "k4_prenorm_early",
                                                              "k4_out_proj_pair")
                                           if path == "fused" else ())
                for path in ("fused", "scan")}
    profiles["fused"]["k4_phases"] = k4_phase_split(profiles["fused"], cfg, BATCH)
    emit({"decode_profile": dict(profiles, card=card)})
    # the SSM phase of the generation went through its tile kernel, and only
    # through it; the pre-norm through the early pre-norm, and only through it
    named = profiles["fused"]["named_ms_per_step"]
    assert named["k4_ssm_tile"] > 0 and named["k4_ssm_tile"] == named["k4_ssm"], named
    assert named["k4_prenorm_early"] > 0 and named["k4_prenorm_early"] == named["k4_prenorm"], named
    # and the out_proj through the pair kernel, and only through it
    assert named["k4_out_proj_pair"] > 0 and named["k4_out_proj_pair"] == named["k4_out_proj"], named
    results["decode_fused"]["scan_step_device_ms"] = profiles["scan"]["device_busy_ms_per_step"]

    torch.cuda.synchronize()
    t_vq = time.time()
    vq_decode_code(params["vq"], tokens, vq_cfg)
    torch.cuda.synchronize()
    vq_s = time.time() - t_vq

    times = {"card": card, "batch": BATCH, "tokens_only_s_fused": tokens_only_s,
             "vq_decode_ms": vq_s * 1e3, "peak_memory_gib": peak_gib,
             "note": "host clock, each ending in a device synchronize; step times from a run "
                     "with a per-token host callback; both paths in this one call"}
    for path in ("fused", "scan"):
        med = float(np.median(totals[path]))
        times[path] = dict(split[path], total_s_runs=totals[path], total_s=med,
                           images_per_s=BATCH / med)
    emit({"times": times})
    return params, model, text_ids, tokens_by["fused"]


def fidelity_phase(params, model, text_ids, card):
    """1.3B greedy text-to-image at B=48 with the weights of the main path:
    the bf16 stream (K1 rounding its product operands where the JAX kernel
    does), and the same with K1 swapped at prefill for `ssd_chunked` on
    widened operands (the arithmetic of K1 before that rounding), each against
    the stream of the same weights in fp32 with an fp32 decode state
    (`eval/fidelity.py`). Per arithmetic: the first divergence (the earliest
    step over the rows), how many rows diverge, and the fp32 replay's top-2
    logit margin at the first divergent token."""
    from omnimamba_tpu_torch.eval import fidelity
    from omnimamba_tpu_torch.models import mamba2
    from omnimamba_tpu_torch.models.backbone import caption_embed, embed_text
    from omnimamba_tpu_torch.ops.ssd_chunked import ssd_chunked
    from omnimamba_tpu_torch.ops.ssd_kernel import PLAIN_CHUNK

    cfg = model.cfg
    ids = torch.as_tensor(text_ids, device="cuda")
    T = PROMPT + cfg.num_tokens

    def embed(m, dtype):
        return caption_embed(m, embed_text(m, ids, dtype)) + m["pos_embed"][:, :PROMPT].to(dtype)

    m16, m32 = params["mamba"], _cast(params["mamba"], torch.float32)
    ref = fidelity.greedy_stream(m32, cfg, ids, embed(m32, torch.float32), "t2i", T,
                                 cache_dtype=None)
    report = fidelity.logit_margin_report(m32, cfg, embed(m32, torch.float32), ref, "t2i", PROMPT)
    margins = report["margins"]
    del m32
    torch.cuda.empty_cache()

    def widened(x, dt, A, Bm, Cm, D=None):
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk_size=PLAIN_CHUNK)

    rec = {"card": card, "batch": BATCH, "new_tokens": cfg.num_tokens,
           "reference": "fp32 weights and decode state, the same seed",
           # the replay runs the layer-by-layer step, the stream the whole-model one
           "fp32_replay_argmax_agrees_share": float(report["argmax_agrees"].mean()),
           "fp32_top2_margin_median": float(np.median(margins)),
           "fp32_top2_margin_min": float(margins.min())}
    kernel = mamba2.ssd_fused
    for name in ("bf16_k1_rounded", "bf16_prefill_widened"):
        mamba2.ssd_fused = kernel if name == "bf16_k1_rounded" else widened
        try:
            got = fidelity.greedy_stream(m16, cfg, ids, embed(m16, torch.bfloat16), "t2i", T)
        finally:
            mamba2.ssd_fused = kernel
        diff = fidelity.compare_streams(got, ref)
        neq = got[:, PROMPT:] != ref[:, PROMPT:]
        first = np.where(neq.any(1), neq.argmax(1), cfg.num_tokens)  # per row
        row = int(first.argmin())
        at = int(first[row])
        rec[name] = {
            "stream_diff": diff._asdict(), "rows_diverged": int(neq.any(1).sum()),
            "tokens_equal_share": float(1.0 - neq.mean()),
            "first_divergence_step": at, "first_divergence_row": row,
            "first_divergence_step_median_of_rows": float(np.median(first)),
            "fp32_top2_margin_there": float(margins[row, at]) if at < cfg.num_tokens else None,
        }
    emit({"fidelity": rec})


def profile_decode_steps(mamba, cfg, ids, emb, decode_impl: str, steps: int = 4, int8_state=False,
                         named=()):
    """Device-busy share of the decode step of one path, from a profiler trace
    of a few steady steps: wall time per step against the summed kernel time
    (and that of the kernels named in `named`, see `profile_steps`). The SSM
    state is bf16, or scaled int8 with `int8_state`."""
    from omnimamba_tpu_torch.models.backbone import (
        apply_head, backbone_forward, backbone_step, backbone_step_fused)
    from omnimamba_tpu_torch.ops.decode_fused import prepare_fused_decode
    from omnimamba_tpu_torch.ops.quant import quantize_ssm_state_by_layer

    _, cache = backbone_forward(mamba, emb, "t2i", cfg, return_cache=True)
    cache = cache._replace(ssm_state=quantize_ssm_state_by_layer(cache.ssm_state) if int8_state
                           else cache.ssm_state.to(torch.bfloat16))
    tok = ids[:, 0] % cfg.vqvae_vocab_size
    if decode_impl == "fused":
        plan = prepare_fused_decode(mamba["layers"], "t2i", cfg.mixer, cfg.lora, BATCH, emb.dtype)

        def backbone(pos):
            return backbone_step_fused(mamba, tok, pos, cache, "t2i", cfg, dtype=emb.dtype, plan=plan)
    else:
        def backbone(pos):
            return backbone_step(mamba, tok, pos, cache, "t2i", cfg, dtype=emb.dtype)

    def step(pos):
        hidden, _ = backbone(pos)
        return apply_head(mamba, hidden, "t2i").argmax(-1)

    return profile_steps(lambda i: step(PROMPT + i), steps, named=named)


# K4's four kernels a layer (and the one after the last layer), by name
K4_PHASES = ("k4_prenorm", "k4_in_proj", "k4_ssm", "k4_out_proj", "k4_finish")


def k4_phase_bytes(m, r, B, io_bytes=2, state_bytes=2, proj_bytes=None):
    """Bytes of each of K4's phases for one layer of mixer config `m`, LoRA rank
    `r`, B rows: each operand read once, each output written once (the
    out_proj's K-split partials and the other task's LoRA left out). Weights and
    activations of `io_bytes`, the SSM state of `state_bytes`, the two
    projections of `proj_bytes` (default `io_bytes`; 1: int8, with their fp32
    column scales), the residual and the small per-head vectors fp32."""
    f = 4
    d, di, din, cd = m.d_model, m.d_inner, m.d_in_proj, m.d_conv_in
    e, H = io_bytes, m.nheads
    p = e if proj_bytes is None else proj_bytes
    scale = f if p == 1 else 0  # an int8 projection's scale, per column
    return {
        # h in, residual in and out, hn out, the norm weight, LoRA A, hn A out
        "k4_prenorm": B * d * e + 2 * B * d * f + B * d * e + d * e + d * r * e + B * r * f,
        # W_in (and its scale), LoRA B, hn and hn A in, the conv windows in and
        # out, conv weight and bias, dt_bias, z | x B C | dt out
        "k4_in_proj": (d * din * p + din * scale + r * din * e + B * d * e + B * r * f
                       + 2 * B * (m.d_conv - 1) * cd * e + m.d_conv * cd * e + cd * e + H * f
                       + B * din * e),
        # the state in and out, z | x B C | dt in, A_log, D, the gated norm's weight,
        # yf w out, a sum of squares per (row, head)
        "k4_ssm": (2 * B * H * m.headdim * m.d_state * state_bytes + B * din * e + 2 * H * f
                   + di * e + B * di * e + B * H * f),
        # W_out (and its scale), yf w in, the fp32 product out
        "k4_out_proj": di * d * p + d * scale + B * di * e + B * d * f,
    }


def k4_phase_split(profile, cfg, B, io_bytes=2, state_bytes=2, proj_bytes=None):
    """K4's step by phase, all layers: each phase's device ms a step from the
    decode profile (its kernels' time, and the part of it that no earlier
    kernel overlaps: the bf16 in_proj starts while the pre-norm runs), beside
    the bytes it must move (`k4_phase_bytes`) and their time at the card's
    memory rate. The products' operations take under 1% of that time at the
    bf16 peak, so each phase is bound by bytes."""
    named, exposed = profile["named_ms_per_step"], profile["named_exposed_ms_per_step"]
    split = {}
    for name, per in k4_phase_bytes(cfg.mixer, cfg.lora.r, B, io_bytes, state_bytes,
                                    proj_bytes).items():
        bound = cfg.n_layer * per / HBM_BYTES_PER_S * 1e3
        split[name] = {"ms_per_step": named[name], "exposed_ms_per_step": exposed[name],
                       "bytes_per_step": cfg.n_layer * per, "bound_ms": bound,
                       "share_of_bound": bound / named[name],
                       "share_of_bound_exposed": bound / exposed[name]}
    split["k4_finish"] = {"ms_per_step": named["k4_finish"]}
    return split


def _kernel_kind(name: str) -> str:
    if "omt::" in name:
        return "port_kernels"
    if any(s in name for s in ("gemm", "nvjet", "cutlass", "cublas", "splitK")):
        return "library_products"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def profile_steps(step, steps: int, top: int = 10, named=()):
    """`step(i)` for i = 1..steps under the profiler, after one warm call
    `step(0)`: wall time per step against the summed time of its kernels
    (and of the kernels whose names hold each string of `named`, with the part
    of it that no earlier kernel overlaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(steps):
            step(1 + i)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps

    def device_us(evt):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return getattr(evt, name)
        return 0.0

    # the part of each kernel's time that no earlier kernel overlaps (a kernel
    # launched as a programmatic dependent starts while the one ahead of it runs);
    # summed over all kernels, the time the device had work at all
    exposed, covered, last_end = {key: 0.0 for key in named}, 0.0, float("-inf")
    for start, end, name in sorted((e.time_range.start, e.time_range.end, e.name)
                                   for e in prof.events() if e.device_type == DeviceType.CUDA):
        part = max(0.0, end - max(start, last_end))
        covered += part
        for key in named:
            if key in name:
                exposed[key] += part
        last_end = max(last_end, end)
    # kernel events only: an operator's row repeats the time of the kernels it launched
    rows = sorted(((device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    if busy_ms <= 0:
        raise RuntimeError("the profiler's trace holds no device time: the device's idle share "
                           "of the decode step cannot be read")
    by_kind = {}
    for us, name, _ in rows:
        kind = _kernel_kind(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
    covered_ms = covered / 1e3 / steps
    return {
        "steps": steps, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_covered_ms_per_step": covered_ms,
        # from the time covered by some kernel: overlapping kernels' summed time
        # can exceed the wall time
        "device_idle_share": 1.0 - covered_ms / wall_ms,
        "kernel_launches_per_step": sum(r[2] for r in rows) / steps,
        "device_ms_per_step_by_kind": by_kind,
        "note": "wall time includes the profiler's own cost on the host",
        "top_kernels": [{"name": k[:60], "ms_per_step": us / 1e3 / steps, "calls_per_step": n / steps}
                        for us, k, n in rows[:top] if us > 0],
        **({"named_ms_per_step": {key: sum(us for us, k, _ in rows if key in k) / 1e3 / steps
                                  for key in named},
            "named_exposed_ms_per_step": {key: us / 1e3 / steps for key, us in exposed.items()}}
           if named else {}),
    }


def _named_leaves(node, name=""):
    """(key of the leaf, tensor) for every tensor of a parameter tree."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _named_leaves(v, k)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _named_leaves(v, name)
    elif isinstance(node, torch.Tensor):
        yield name, node


def _leaves(node):
    return (t for _, t in _named_leaves(node))


# ---------------------------------------------------------------------------
# phases: int8 serving at 1.3B: text-to-image, the slot engine, speculative decoding
# ---------------------------------------------------------------------------


def _first_divergence(a, b):
    """Per row of two (B, T) token tensors: the first index where they differ
    (T where they never do)."""
    diff = a != b
    T = a.shape[1]
    return torch.where(diff.any(1), diff.int().argmax(1), torch.full_like(diff[:, 0], T, dtype=torch.long))


def int8_path(params, model, text_ids, bf16_tokens, results, card):
    """`t2i_generate` at 1.3B on `quantize_decode_params(bf16 weights)`, batch
    48, on the whole-model step (decode_impl="auto") and on the layer loop
    with the scaled-int8 state (cache_dtype="int8"), launch counters set to 0
    just before each and read just after. Returns the int8 backbone."""
    from omnimamba_tpu_torch import SampleParams, t2i_generate
    from omnimamba_tpu_torch.models.backbone import caption_embed, embed_text
    from omnimamba_tpu_torch.models.generation import generate
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params

    cfg, mamba = model.cfg, params["mamba"]
    torch.cuda.synchronize()
    t0 = time.time()
    qmamba = quantize_decode_params(mamba)
    torch.cuda.synchronize()
    quantize_s = time.time() - t0
    qparams = {"mamba": qmamba, "vq": params["vq"]}
    greedy = SampleParams(top_k=1)
    ids = torch.as_tensor(text_ids, device="cuda")
    L, steps = cfg.n_layer, cfg.num_tokens - 1
    wrappers = kernel_wrappers()
    zero = dict.fromkeys(wrappers, 0)
    # prefill: in_proj and out_proj a layer and the head; a step: project_in fc1-fc3
    # and the head, and on the layer loop in_proj and out_proj a layer
    expect = {
        "fused": dict(zero, ssd_scan=L, add_rms_norm=L, gated_rms_norm=L,
                      qmatmul=2 * L + 1 + 4 * steps, decode_fused_int8=steps),
        "scan_int8_state": dict(zero, ssd_scan=L, add_rms_norm=L * (steps + 1),
                                gated_rms_norm=L * (steps + 1),
                                qmatmul=2 * L + 1 + (4 + 2 * L) * steps, ssd_step_int8=L * steps),
    }
    path_kw = {"fused": {}, "scan_int8_state": {"cache_dtype": "int8"}}
    t2i_generate(qparams, model, text_ids, sample=greedy, decode_image=False)  # warm-up
    launches, report, tokens_by, peak_gib = {}, {}, {}, 0.0
    for path, kw in path_kw.items():
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t = time.time()
        images, tokens = t2i_generate(qparams, model, text_ids, sample=greedy, **kw)
        torch.cuda.synchronize()
        total_s = time.time() - t
        peak = torch.cuda.max_memory_allocated()
        peak_gib = max(peak_gib, peak / 2**30)
        launches[path] = {k: w.launches for k, w in wrappers.items()}
        tokens_by[path] = tokens
        report[path] = {
            "total_s": total_s, "images_per_s": BATCH / total_s,
            "tokens_in_range": (tuple(tokens.shape) == (BATCH, cfg.num_tokens)
                                and int(tokens.min()) >= 0
                                and int(tokens.max()) < cfg.vqvae_vocab_size),
            "images_finite": (tuple(images.shape) == (BATCH, 256, 256, 3)
                              and bool(torch.isfinite(images.float()).all())),
            "launches": launches[path], "launches_expected": expect[path],
            # the path's own peak: above what was allocated when it started (the weights)
            "own_peak_gib": (peak - resident) / 2**30,
        }

    def embed():
        return caption_embed(qmamba, embed_text(qmamba, ids, torch.bfloat16)) + qmamba["pos_embed"][:, :PROMPT]

    for path, kw in path_kw.items():
        stamps = []
        torch.cuda.synchronize()
        t_start = time.time()
        generate(qmamba, cfg, input_ids=ids, input_embeddings=embed(), task="t2i",
                 max_length=PROMPT + cfg.num_tokens, sample=greedy,
                 token_callback=lambda _tok: stamps.append(time.time()), **kw)
        step_ms = np.diff(np.asarray(stamps)) * 1e3
        prof = profile_decode_steps(qmamba, cfg, ids, embed(), "fused" if path == "fused" else "scan",
                                    int8_state=path != "fused")
        report[path].update(
            prefill_and_first_token_ms=(stamps[0] - t_start) * 1e3,
            decode_step_ms_median=float(np.median(step_ms)),
            decode_step_ms_p90=float(np.percentile(step_ms, 90)),
            kernel_launches_per_step=prof["kernel_launches_per_step"],
            device_idle_share=prof["device_idle_share"],
            device_busy_ms_per_step=prof["device_busy_ms_per_step"],
            top_kernels=prof["top_kernels"][:6])

    k3 = norms_in_int8_state_loop(qmamba, cfg, ids, embed, tokens_by["scan_int8_state"])
    report["scan_int8_state"]["k3_against_parent"] = k3
    for name in ("add_rms_norm", "gated_rms_norm"):
        results[name]["int8_state_step"] = k3

    first = _first_divergence(tokens_by["fused"], bf16_tokens)
    first_state = _first_divergence(tokens_by["scan_int8_state"], tokens_by["fused"])
    rec = {
        "card": card, "model": "OmniMamba-1.3B", "batch": BATCH, "prompt": PROMPT,
        "new_tokens": cfg.num_tokens, "quantize_s": quantize_s,
        "weight_bytes_bf16": nbytes(*_leaves(mamba)), "weight_bytes_int8": nbytes(*_leaves(qmamba)),
        "step_weight_bytes_bf16": nbytes(*_leaves(mamba["layers"]), *_leaves(mamba["img_embeddings"])),
        "step_weight_bytes_int8": nbytes(*_leaves(qmamba["layers"]), *_leaves(qmamba["img_embeddings"])),
        "peak_memory_gib": peak_gib,
        "against_bf16": {"rows_identical": int((first == cfg.num_tokens).sum()),
                         "first_divergence_step_min": int(first.min()),
                         "first_divergence_step_median": float(first.float().median()),
                         "tokens_equal_share": float((tokens_by["fused"] == bf16_tokens).float().mean())},
        "int8_state_against_fused": {
            "rows_identical": int((first_state == cfg.num_tokens).sum()),
            "first_divergence_step_median": float(first_state.float().median())},
        "fused": report["fused"], "scan_int8_state": report["scan_int8_state"],
        "note": "host clock, each run ending in a device synchronize; step times from a run "
                "with a per-token host callback; idle share from a profiled window of 4 steps",
    }
    emit({"int8_path": rec})
    for path in path_kw:
        assert report[path]["tokens_in_range"] and report[path]["images_finite"], (path, rec)
        assert launches[path] == expect[path], (path, launches[path], expect[path])
    results["qmatmul"]["launches"] = launches["fused"]["qmatmul"]
    results["qmatmul"]["launches_scan_path"] = launches["scan_int8_state"]["qmatmul"]
    results["decode_fused_int8"]["launches"] = launches["fused"]["decode_fused_int8"]
    results["ssd_step_int8"]["launches"] = launches["scan_int8_state"]["ssd_step_int8"]
    return qmamba


def norms_in_int8_state_loop(qmamba, cfg, ids, embed, tokens):
    """K3a and K3b in the int8-state layer loop at B=48: the decode-rows kernel
    against the parent kernels (`norm_parent_entries`) in this process, each
    reached through `parent_norms`. For
    each, a profiled window of 4 steps (K3's device time a step, device busy,
    idle share) and greedy generations in turns (parent, new, new, parent): the
    host clock of each, its step median, and its tokens, which must equal
    `tokens` (the int8-state path's run)."""
    from omnimamba_tpu_torch import SampleParams
    from omnimamba_tpu_torch.models.generation import generate
    from omnimamba_tpu_torch.ops import kernel_build

    parent = norm_parent_entries()
    named = (NORM_ROWS_KERNEL, "add_rms_norm_kernel", "gated_rms_norm_kernel", "ssd_step_q8")
    out = {"processes": "one: the parent kernels swapped in through `only`", "runs": []}

    def run(label):
        stamps = []
        torch.cuda.synchronize()
        t0 = time.time()
        seq = generate(qmamba, cfg, input_ids=ids, input_embeddings=embed(), task="t2i",
                       max_length=PROMPT + cfg.num_tokens, sample=SampleParams(top_k=1),
                       cache_dtype="int8", token_callback=lambda _tok: stamps.append(time.time()))
        torch.cuda.synchronize()
        total = time.time() - t0
        got = seq.sequences[:, PROMPT:]
        assert torch.equal(got, tokens), f"{label}: the int8-state tokens changed"
        out["runs"].append({"kernels": label, "total_s": total,
                            "decode_step_ms_median": float(np.median(np.diff(stamps)) * 1e3)})

    # both through `only`, so that the host's cost a call is the same
    shipped = {e: getattr(kernel_build.load_kernels(), e) for e in NORM_ENTRIES}
    for label in ("parent", "norm_rows", "norm_rows", "parent"):
        with parent_norms(parent if label == "parent" else shipped):
            run(label)
            if label not in out:
                prof = profile_decode_steps(qmamba, cfg, ids, embed(), "scan", int8_state=True,
                                            named=named)
                out[label] = {"k3_ms_per_step": sum(prof["named_ms_per_step"][k] for k in named[:3]),
                              "named_ms_per_step": prof["named_ms_per_step"],
                              "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
                              "device_idle_share": prof["device_idle_share"],
                              "wall_ms_per_step": prof["wall_ms_per_step"],
                              "kernel_launches_per_step": prof["kernel_launches_per_step"]}
    assert out["norm_rows"]["named_ms_per_step"][NORM_ROWS_KERNEL] > 0, out
    assert out["parent"]["named_ms_per_step"][NORM_ROWS_KERNEL] == 0, out
    return out


def _solo_stream(mamba, cfg, prompt_ids, emb, new, dtype, cache_dtype):
    from omnimamba_tpu_torch import SampleParams, generate

    out = generate(mamba, cfg, input_ids=prompt_ids, input_embeddings=emb.to(dtype), task="mmu",
                   max_length=prompt_ids.shape[1] + new, sample=SampleParams(top_k=1),
                   cache_dtype=cache_dtype)
    return out.sequences[0, prompt_ids.shape[1]:].tolist()


def _agreement(got, want):
    """(identical, first index where the two lists differ or None)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return False, i
    return len(got) == len(want), None if len(got) == len(want) else min(len(got), len(want))


def slot_engine_phase(qmamba, cfg, card):
    """The slot engine at 1.3B as scripts/bench_continuous.py drives the JAX
    one: int8 weights, bf16 state, 16 slots, chunks of 16 steps, 64 text
    requests (task mmu) of 64 ids with budgets drawn from {32, 64, 128, 256},
    all submitted at once. Then 8 of them against solo `generate`, and at 4
    layers in fp32 every stream against its solo stream (which must be equal)."""
    from omnimamba_tpu_torch import MambaConfig
    from omnimamba_tpu_torch.models.backbone import embed_text, init_backbone
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params
    from omnimamba_tpu_torch.serve.continuous import SlotEngine

    bf, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(SEED)
    n_req, plen = 64, 64
    budgets = rng.choice([32, 64, 128, 256], size=n_req)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (n_req, plen)), device="cuda")
    emb = embed_text(qmamba, prompts, bf).float()
    emb_host = emb.cpu().numpy()
    eng = SlotEngine(qmamba, cfg, n_slots=16, chunk=16, task="mmu", dtype=bf, state_dtype=bf)
    assert eng.fused
    t_w = time.time()
    eng.warmup([plen])
    warmup_s = time.time() - t_w
    eng.timings = {k: [] for k in eng.timings}
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(emb_host[i], plen, max_new=int(budgets[i])) for i in range(n_req)]
    done_at, ticks = {}, 0
    while len(done_at) < n_req:
        eng.tick()
        ticks += 1
        now = time.perf_counter() - t0
        for i, r in enumerate(reqs):
            if i not in done_at and r.done.is_set():
                done_at[i] = now
        assert ticks < 10_000, "the engine did not drain"
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    lat = np.asarray([done_at[i] for i in range(n_req)])
    useful = sum(len(r.tokens) for r in reqs)
    assert all(len(r.tokens) == int(b) for r, b in zip(reqs, budgets))
    solo = []
    for i in range(8):
        want = _solo_stream(qmamba, cfg, prompts[i:i + 1], emb[i:i + 1], int(budgets[i]), bf, bf)
        same, at = _agreement(reqs[i].tokens, want)
        solo.append({"request": i, "budget": int(budgets[i]), "identical": same, "first_divergence": at})
    rec = {
        "card": card, "model": "OmniMamba-1.3B", "weights": "int8 projections, tables and "
        "project_in (quantize_decode_params of bf16)", "state_dtype": "torch.bfloat16",
        "n_slots": 16, "chunk": 16, "requests": n_req, "prompt": plen,
        "budgets": {str(b): int((budgets == b).sum()) for b in (32, 64, 128, 256)},
        "warmup_s": warmup_s, "wall_s": wall, "useful_tokens": useful, "useful_tok_per_s": useful / wall,
        "latency_s_p50": float(np.percentile(lat, 50)), "latency_s_p95": float(np.percentile(lat, 95)),
        "ticks": ticks, "chunk_ms_median": 1e3 * float(np.median(eng.timings["chunk"])),
        "prefill_ms_median": 1e3 * float(np.median(eng.timings["prefill"])),
        "insert_ms_median": 1e3 * float(np.median(eng.timings["insert"])),
        "prefill_groups": len(eng.timings["prefill"]), "launches": launches,
        "solo_identical": sum(r["identical"] for r in solo), "solo": solo,
        "note": "host clock; latency from the common submit to the tick that finished the "
                "request; chunk, prefill and insert each end in a host read or synchronize",
    }
    assert launches.get("decode_fused_int8", 0) > 0 and launches.get("qmatmul", 0) > 0, rec
    assert rec["solo_identical"] == len(solo), rec  # a row's bits do not depend on its batch
    del eng
    torch.cuda.empty_cache()

    # fp32 at 4 layers: per-row arithmetic that depends neither on the batch nor
    # on the slot, so every stream must equal its solo stream (int8 weights, so
    # every product is K7's or K4's fp32 multiply-add, row by row)
    cfg4 = dataclasses.replace(MambaConfig(), n_layer=4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    p4 = quantize_decode_params(init_backbone(gen, cfg4, f32, "cuda"))
    rng4 = np.random.default_rng(SEED + 4)
    lens = [32, 64, 64, 32, 64, 32, 64, 64]
    news = rng4.choice([8, 16, 24, 40], size=len(lens))
    ids4 = [torch.as_tensor(rng4.integers(0, cfg4.vocab_size, (1, n)), device="cuda") for n in lens]
    embs4 = [embed_text(p4, i, f32) for i in ids4]
    eng4 = SlotEngine(p4, cfg4, n_slots=4, chunk=8, task="mmu", dtype=f32)
    reqs4 = [eng4.submit(e[0].cpu().numpy(), e.shape[1], max_new=int(n)) for e, n in zip(embs4, news)]
    eng4.run_until_drained()
    exact = []
    for r, i, e, n in zip(reqs4, ids4, embs4, news):
        same, at = _agreement(r.tokens, _solo_stream(p4, cfg4, i, e, int(n), f32, None))
        exact.append(at if not same else -1)
    rec["fp32_4_layers"] = {"requests": len(lens), "n_slots": 4, "chunk": 8,
                            "streams_equal_to_solo": sum(a == -1 for a in exact),
                            "first_divergence": exact}
    emit({"slot_engine": rec})
    assert all(a == -1 for a in exact), rec["fp32_4_layers"]


def speculative_phase(mamba, qmamba, cfg, card):
    """Speculative decoding at 1.3B with the bf16 target, B=1 and a 64-id
    prompt, with three drafts against plain greedy decoding on the same card:
    the int8 model for 128 new tokens, and the first 8 layers and prompt
    lookup, which accept next to nothing on random weights (a round then
    yields one token, whose cost the verify-pass profile gives), for 32. Where
    a stream leaves plain greedy, plain greedy's top-2 margin there and the
    gap of the same two logits when the plain stream is replayed through the
    continuation prefill (the verify pass's code path). Then at 4 layers in
    fp32, where the streams must equal plain greedy."""
    from omnimamba_tpu_torch import MambaConfig, SampleParams, generate
    from omnimamba_tpu_torch.models.backbone import (
        apply_head, backbone_forward, embed_decode_window, embed_text, init_backbone)
    from omnimamba_tpu_torch.models.speculative import speculative_generate
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params

    bf, f32 = torch.bfloat16, torch.float32
    greedy = SampleParams(top_k=1)
    plen, new = 64, 128
    ids = torch.as_tensor(np.random.default_rng(SEED + 3).integers(0, cfg.vocab_size, (1, plen)),
                          device="cuda")
    emb = embed_text(mamba, ids, bf)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    def plain():
        return generate(mamba, cfg, input_ids=ids, input_embeddings=emb, task="mmu",
                        max_length=plen + new, sample=greedy, cache_dtype=None, return_logits=True)

    plain()  # warm-up
    ref, plain_s = timed(plain)
    ref_toks = ref.sequences[0, plen:].tolist()
    _, cache = backbone_forward(mamba, emb, "mmu", cfg, return_cache=True)

    def divergence(at, spec_tok):
        p_tok = ref_toks[at]
        row = ref.logits[at][0]
        if at == 0:
            row_v = apply_head(mamba, backbone_forward(mamba, emb, "mmu", cfg)[0][0, -1], "mmu")
        else:
            e = embed_decode_window(mamba, ref.sequences[:, plen:plen + at], plen, "mmu", cfg, bf)
            h, _ = backbone_forward(mamba, e, "mmu", cfg, add_mmu_pos=False, return_cache=True,
                                    initial_cache=cache, valid_len=torch.tensor([at], device="cuda"))
            row_v = apply_head(mamba, h[0, -1], "mmu")
        top2 = torch.topk(row, 2).values
        return {"plain_token": p_tok, "speculative_token": spec_tok,
                "plain_top2_margin": float(top2[0] - top2[1]),
                "plain_logit_gap": float(row[p_tok] - row[spec_tok]),
                "continuation_logit_gap": float(row_v[p_tok] - row_v[spec_tok]),
                "continuation_argmax": int(torch.argmax(row_v))}

    drafts = {"int8": (dict(draft_params=qmamba), new),
              "first_8_layers": (dict(draft_layers=8), 32), "ngram": (dict(draft_mode="ngram"), 32)}
    rec = {"card": card, "model": "OmniMamba-1.3B", "target": "torch.bfloat16", "prompt": plen,
           "new_tokens": new, "k_draft": 8, "plain_greedy_s": plain_s,
           "plain_greedy_tok_per_s": new / plain_s, "drafts": {}}
    for name, (kw, n) in drafts.items():
        out, secs = timed(lambda: speculative_generate(
            mamba, cfg, input_ids=ids, input_embeddings=emb, task="mmu", max_length=plen + n,
            k_draft=8, **kw))
        got = out.sequences[0, plen:plen + out.num_generated].tolist()
        same, at = _agreement(got, ref_toks[:n])
        rec["drafts"][name] = {
            "new_tokens": n, "seconds": secs, "tok_per_s": out.num_generated / secs,
            "speedup_over_plain": out.num_generated / secs / rec["plain_greedy_tok_per_s"],
            "rounds": out.rounds, "drafted": out.drafted,
            "accepted": out.accepted, "acceptance": out.accepted / max(out.drafted, 1),
            "stream_identical_to_plain": same, "first_divergence": at,
            "at_divergence": divergence(at, got[at]) if at is not None and at < len(got) else None}

    # where a round's time goes: one verify pass of the target, a window of
    # 2K+2 = 18 tokens through the continuation prefill, and its argmax read
    window, valid = ids[:, :18], torch.tensor([18], device="cuda")

    def verify(_i=0):
        e = embed_decode_window(mamba, window, plen, "mmu", cfg, bf)
        h, _ = backbone_forward(mamba, e, "mmu", cfg, add_mmu_pos=False, return_cache=True,
                                initial_cache=cache, valid_len=valid)
        return torch.argmax(apply_head(mamba, h[0], "mmu"), dim=-1).cpu()

    prof = profile_steps(verify, 3)
    rec["verify_pass"] = {
        "window": 18, "host_clock_ms": timed(lambda: [verify() for _ in range(3)])[1] * 1e3 / 3,
        **{k: prof[k] for k in ("device_busy_ms_per_step", "kernel_launches_per_step",
                                "device_ms_per_step_by_kind")}}
    del cache

    cfg4 = dataclasses.replace(MambaConfig(), n_layer=4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    p4 = init_backbone(gen, cfg4, f32, "cuda")
    q4 = quantize_decode_params(p4)
    emb4 = embed_text(p4, ids, f32)
    want = generate(p4, cfg4, input_ids=ids, input_embeddings=emb4, task="mmu", max_length=plen + 48,
                    sample=greedy, cache_dtype=None, return_logits=True)
    exact = {}
    for name, kw in {"int8": dict(draft_params=q4), "first_2_layers": dict(draft_layers=2),
                     "ngram": dict(draft_mode="ngram")}.items():
        out = speculative_generate(p4, cfg4, input_ids=ids, input_embeddings=emb4, task="mmu",
                                   max_length=plen + 48, k_draft=4, **kw)
        same, at = _agreement(out.sequences[0].tolist(), want.sequences[0].tolist())
        margin = None
        if not same:
            top2 = torch.topk(want.logits[at - plen][0], 2).values
            margin = float(top2[0] - top2[1])
        exact[name] = {"identical": same, "first_divergence": at, "top2_margin_there": margin,
                       "accepted": out.accepted, "drafted": out.drafted}
    rec["fp32_4_layers"] = exact
    emit({"speculative": rec})
    assert all(v["identical"] for v in exact.values()), exact
    assert all(v["tok_per_s"] > 0 for v in rec["drafts"].values())


# ---------------------------------------------------------------------------
# phase: kernels against plain versions, end to end through the decode engine
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_versions():
    """Test-only switch: route the model's five kernel call sites to the plain
    tensor versions by patching the names the model modules look up."""
    import omnimamba_tpu_torch.models.backbone as backbone
    import omnimamba_tpu_torch.models.blocks as blocks
    import omnimamba_tpu_torch.models.mamba2 as mamba2
    from omnimamba_tpu_torch.ops.decode_fused import fused_decode_step_plain
    from omnimamba_tpu_torch.ops.norms import add_norm_plain, gated_rms_norm_plain
    from omnimamba_tpu_torch.ops.ssd_kernel import ssd_fused_plain
    from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_plain

    def step_plain_in_place(x, dt, A, Bm, Cm, D, state):
        y, new_state = ssd_step_plain(x, dt, A, Bm, Cm, D, state)
        state.copy_(new_state)
        return y, state

    def fused_plain(*args, plan=None):
        return fused_decode_step_plain(*args)

    saved = (blocks.add_norm, mamba2.gated_rms_norm, mamba2.ssd_fused, mamba2.ssd_step_fused,
             backbone.fused_decode_step)
    blocks.add_norm, mamba2.gated_rms_norm = add_norm_plain, gated_rms_norm_plain
    mamba2.ssd_fused, mamba2.ssd_step_fused = ssd_fused_plain, step_plain_in_place
    backbone.fused_decode_step = fused_plain
    try:
        yield
    finally:
        (blocks.add_norm, mamba2.gated_rms_norm, mamba2.ssd_fused, mamba2.ssd_step_fused,
         backbone.fused_decode_step) = saved


def plain_vs_kernel():
    """The decode engine at full width, 4 layers, fp32, once per decode path:
    once through the kernels (free-running greedy), once through the plain
    versions replaying the kernel run's tokens, so the logits of every step
    are comparable."""
    from omnimamba_tpu_torch import MambaConfig, SampleParams
    from omnimamba_tpu_torch.models.backbone import caption_embed, embed_text, init_backbone
    from omnimamba_tpu_torch.models.generation import generate

    B, new = 4, 24
    cfg = dataclasses.replace(MambaConfig(), n_layer=4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = init_backbone(gen, cfg, torch.float32, "cuda")
    for layer in params["layers"]:  # LoRA B starts at zero; make the branch count
        lora = layer["mixer"]["lora"]
        lora["t2i_B"] = 0.02 * torch.randn(
            lora["t2i_B"].shape, generator=gen, device="cuda", dtype=torch.float32)
    ids = torch.as_tensor(
        np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (B, PROMPT)), device="cuda")
    emb = caption_embed(params, embed_text(params, ids, torch.float32))
    emb = emb + params["pos_embed"][:, :PROMPT]
    common = dict(input_ids=ids, input_embeddings=emb, task="t2i", max_length=PROMPT + new,
                  sample=SampleParams(top_k=1), cache_dtype=None, return_logits=True)

    wrappers = kernel_wrappers()
    idle = {"scan": "decode_fused", "fused": "ssd_step"}  # the kernel the path does not run
    for path in ("scan", "fused"):
        for w in wrappers.values():
            w.launches = 0
        out_k = generate(params, cfg, decode_impl=path, **common)
        before = {k: w.launches for k, w in wrappers.items()}
        assert all((n > 0) != (k == idle[path] or k in BACKWARD_KERNELS + INT8_KERNELS)
                   for k, n in before.items()), (path, before)
        with plain_versions():
            out_p = generate(params, cfg, decode_impl=path, teacher_outputs=out_k.sequences, **common)
        assert before == {k: w.launches for k, w in wrappers.items()}, "plain run launched a kernel"

        lk, lp = torch.stack(out_k.logits), torch.stack(out_p.logits)  # (steps, B, V)
        scale = lp.abs().max().item()
        err = (lk - lp).abs().max().item()
        # fp32 end to end over 4 layers and 24 recurrent steps: the kernels sum in
        # another order than the plain versions and the differences compound
        # through the layers; 1e-5 of the largest logit is about 80 fp32 ulps
        tol = 1e-5 * scale
        top2 = torch.topk(lp, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]  # (steps, B)
        toks_k = out_k.sequences[:, PROMPT:].T  # (steps, B)
        agree = lp.argmax(-1) == toks_k
        decided = margin > 2 * tol  # a near-tie inside the tolerance decides nothing
        rec = {"decode_impl": path, "layers": cfg.n_layer, "d_model": cfg.d_model, "batch": B,
               "steps": new, "logits_max_abs_err": err, "logits_scale": scale, "tol_abs": tol,
               "tokens_equal": bool(agree.all()), "near_ties": int((~decided).sum()),
               "min_margin": margin.min().item()}
        emit({"plain_vs_kernel": rec})
        assert err <= tol, rec
        assert bool(agree[decided].all()), rec


# ---------------------------------------------------------------------------
# phase: training, kernels against plain versions end to end
# ---------------------------------------------------------------------------


def _require_grad(params):
    leaves = []
    for name, t in _named_leaves(params):
        leaves.append((name, t.requires_grad_()))
    return leaves


def _synthetic_t2i_batch(rng, cfg, batch):
    return {"t2i_flow": {
        "inputs": rng.integers(0, cfg.vqvae_vocab_size, (batch, cfg.num_tokens)),
        "caption_ids": rng.integers(0, cfg.vocab_size, (batch, PROMPT)),
    }}


def train_plain_vs_kernel():
    """`t2i_loss` and the gradient of every parameter at full width, 3 layers,
    fp32, once through the kernels (forward and backward) and once through the
    plain versions differentiated by autograd; then the kernel run again with
    every block checkpointed, which must give the same bits."""
    from omnimamba_tpu_torch import MambaConfig, OmniMambaModel, VQConfig, init_omnimamba
    from omnimamba_tpu_torch.models.omnimamba import t2i_loss

    B = 2
    cfg = dataclasses.replace(MambaConfig(), n_layer=3)
    model = OmniMambaModel(cfg=cfg, vq_cfg=VQConfig(), sptids={})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    params = init_omnimamba(gen, model, torch.float32, "cuda", with_vq=False)
    for layer in params["mamba"]["layers"]:  # LoRA B starts at zero; make the branch count
        lora = layer["mixer"]["lora"]
        lora["t2i_B"] = 0.02 * torch.randn(
            lora["t2i_B"].shape, generator=gen, device="cuda", dtype=torch.float32)
    named = _require_grad(params)
    leaves = [t for _, t in named]
    flow = _synthetic_t2i_batch(np.random.default_rng(SEED + 2), cfg, B)["t2i_flow"]
    img = torch.as_tensor(flow["inputs"], device="cuda")
    cap = torch.as_tensor(flow["caption_ids"], device="cuda")

    def run(remat, seed=None):
        g = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
        loss = t2i_loss(params, model, img, cap, dtype=torch.float32, generator=g, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)

    wrappers = kernel_wrappers()
    counts = {}
    for remat in (False, True):
        for w in wrappers.values():
            w.launches = 0
        out = run(remat)
        counts[remat] = {k: w.launches for k, w in wrappers.items() if w.launches}
        if remat:
            loss_r, grads_r = out
        else:
            loss_k, grads_k = out
    n = cfg.n_layer
    forward = ("ssd_scan", "add_rms_norm", "gated_rms_norm")
    assert counts[False] == {**dict.fromkeys(forward, n), **dict.fromkeys(BACKWARD_KERNELS, n)}, counts
    assert counts[True] == {**dict.fromkeys(forward, 2 * n), **dict.fromkeys(BACKWARD_KERNELS, n)}, counts
    with plain_versions():
        loss_p, grads_p = run(False)
    assert counts[True] == {k: w.launches for k, w in wrappers.items() if w.launches}, \
        "plain run launched a kernel"

    # fp32 end to end through 3 layers: kernel and plain version sum in another
    # order; a gradient leaf is held to 1e-4 of its largest reference value
    tol_rel = 1e-4
    worst, worst_leaf, unused = 0.0, "", []
    for (name, _), gk, gp, gr in zip(named, grads_k, grads_p, grads_r):
        if gp is None:  # the other task's LoRA and positions take no part in a t2i loss
            assert gk is None and gr is None, name
            unused.append(name)
            continue
        assert torch.isfinite(gk).all(), name
        share = (gk - gp).abs().max().item() / (tol_rel * max(gp.abs().max().item(), 1e-30))
        if share > worst:
            worst, worst_leaf = share, name
        assert torch.equal(gk, gr), (name, "checkpointing changed a gradient")
    rec = {"layers": n, "d_model": cfg.d_model, "batch": B, "tokens": B * TRAIN_LEN,
           "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
           "loss_rel_err": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
           "gradient_leaves": len(named) - len(unused), "unused_leaves": sorted(set(unused)),
           "worst_gradient_err_of_allowed": worst, "worst_leaf": worst_leaf, "tol_rel": tol_rel,
           "checkpointed_equals_bit_for_bit": True, "launches": counts[False],
           "launches_checkpointed": counts[True]}
    # dropout: the recompute must draw the first run's masks
    _, g_a = run(False, seed=11)
    _, g_b = run(True, seed=11)
    rec["dropout_masks_repeat_under_checkpointing"] = all(
        torch.equal(a, b) for a, b in zip(g_a, g_b) if a is not None)
    emit({"train_plain_vs_kernel": rec})
    assert rec["loss_rel_err"] <= 1e-5 and worst <= 1.0, rec
    assert torch.equal(loss_k, loss_r) and rec["dropout_masks_repeat_under_checkpointing"], rec


# ---------------------------------------------------------------------------
# phase: the training path
# ---------------------------------------------------------------------------


class _StepLog:
    """Metrics sink of the trainer that also stamps the host's clock: the
    float() of a metric waits for the device, so the time between two
    entries is one whole step."""

    def __init__(self):
        self.rows, self.stamps = [], []

    def log(self, step, metrics):
        torch.cuda.synchronize()
        self.stamps.append(time.time())
        self.rows.append(dict(metrics, step=step))


def train_path(results, card):
    """Stage-1 text-to-image training at the full 1.3B width and depth:
    `Trainer.train(max_steps=3)` on synthetic batches, launch counters set to 0
    just before and read just after; then the split of a step, one profiled
    step, and the peaks behind the rule that resolves remat="proj"."""
    from omnimamba_tpu_torch import MambaConfig, OmniMambaModel, VQConfig, init_omnimamba
    from omnimamba_tpu_torch.config import TrainConfig
    from omnimamba_tpu_torch.models.omnimamba import t2i_loss
    from omnimamba_tpu_torch.train.optimizer import make_schedule
    from omnimamba_tpu_torch.train.trainer import REMAT_TOKENS, Trainer, clip_and_apply, resolve_remat

    cfg = MambaConfig()
    model = OmniMambaModel(cfg=cfg, vq_cfg=VQConfig(), sptids={})
    steps = 3
    wrappers = kernel_wrappers()
    tries = []
    batch = TRAIN_BATCH
    while True:
        # config/config_stage1_t2i.yaml; logging every step so that every loss is seen
        tcfg = TrainConfig(stage="align", t2i_task=True, mmu_task=False, batch_size_t2i=batch,
                           lr=8e-4, warmup_steps=1000, max_steps=100000, logging_steps=1)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = init_omnimamba(gen, model, torch.bfloat16, "cuda", with_vq=False)
        before = {name: t.detach().clone() for name, t in _paths(params)}
        rng = np.random.default_rng(SEED)
        loader = [_synthetic_t2i_batch(rng, cfg, batch) for _ in range(steps)]
        log = _StepLog()
        trainer = Trainer(model, params, tcfg, loader, dtype=torch.bfloat16,
                          metrics_writer=log, log_fn=lambda line: None)
        tokens = batch * TRAIN_LEN
        remat = resolve_remat(tcfg.remat, tokens)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.time()
        try:
            state, _ = trainer.train(max_steps=steps)
        except torch.cuda.OutOfMemoryError:
            tries.append({"batch": batch, "fits": False,
                          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
            del trainer, params, before
            torch.cuda.empty_cache()
            batch //= 2
            assert batch >= 1, tries
            continue
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        tries.append({"batch": batch, "fits": True, "peak_memory_gib": peak_gib})
        break

    n = cfg.n_layer
    fwd = n * steps * (2 if remat else 1)  # checkpointing runs every forward again
    expect = {"ssd_scan": fwd, "add_rms_norm": fwd, "gated_rms_norm": fwd, "ssd_step": 0,
              "decode_fused": 0, **dict.fromkeys(BACKWARD_KERNELS, n * steps),
              **dict.fromkeys(INT8_KERNELS, 0)}
    losses = [row["loss"] for row in log.rows]
    step_s = np.diff(np.asarray([t_start] + log.stamps))
    # gate 4's checks: the mixer core is frozen, the image embeddings and the LoRA move
    moved = {name: (t.detach() != before[name]).any().item() for name, t in _paths(params)}
    frozen_moved = sorted(k for k, m in moved.items() if m and not _trains_in_align_t2i(k))
    rec = {
        "model": "OmniMamba-1.3B", "n_layer": n, "d_model": cfg.d_model, "stage": tcfg.stage,
        "batch": batch, "seq_len": TRAIN_LEN, "tokens_per_step": tokens, "steps": steps,
        "remat": tcfg.remat, "remat_resolved": remat, "remat_rule_tokens": REMAT_TOKENS,
        "lr": tcfg.lr, "warmup_steps": tcfg.warmup_steps, "dtype": "torch.bfloat16",
        "batch_tries": tries, "losses": losses, "grad_norms": [r["grad_norm"] for r in log.rows],
        "state_step": state.step, "launches": launches, "launches_expected": expect,
        "trainable_leaves": sum(t.requires_grad for _, t in _paths(params)),
        "trainable_parameters": sum(t.numel() for _, t in _paths(params) if t.requires_grad),
        "frozen_leaves_that_moved": frozen_moved,
        "img_embeddings_moved": any(m for k, m in moved.items() if "img_embeddings" in k),
        "lora_moved": any(m for k, m in moved.items() if "lora/t2i" in k),
    }
    emit({"train_path": rec})
    assert len(losses) == steps and all(np.isfinite(losses)), rec
    assert state.step == steps and launches == expect, rec
    assert not frozen_moved and rec["img_embeddings_moved"] and rec["lora_moved"], rec
    del before
    for name in expect:
        if name in INT8_KERNELS:
            continue
        results[name]["launches_train"] = launches[name]
        results[name]["launches_per_train_step"] = launches[name] // steps
        if name in BACKWARD_KERNELS:
            results[name]["launches"] = launches[name]

    # ---- the split of one step: forward, backward (with its recompute), update ----
    flow = {k: torch.as_tensor(v, device="cuda") for k, v in loader[0]["t2i_flow"].items()}
    leaves = [t for _, t in _paths(params) if t.requires_grad]
    schedule = make_schedule(tcfg)

    def manual_step():
        marks = [time.time()]
        loss = t2i_loss(params, model, flow["inputs"], flow["caption_ids"], dtype=torch.bfloat16,
                        generator=trainer.generator, remat=remat)
        torch.cuda.synchronize()
        marks.append(time.time())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        torch.cuda.synchronize()
        marks.append(time.time())
        trainer.state, _ = clip_and_apply(trainer.state, trainer.tx, schedule, grads)
        torch.cuda.synchronize()
        marks.append(time.time())
        return np.diff(marks)

    splits = np.asarray([manual_step() for _ in range(3)])
    split = np.median(splits, axis=0)
    profile = profile_steps(
        lambda i: trainer.step_fn(trainer.state, loader[0], trainer.generator), 1, top=24,
        named=("ssd_scan_bwd", "ssd_bwd_reduce", "ssd_scan_bf16_kernel", "ssd_scan_kernel",
               "gated_rms_norm_bwd", "norm_dw_reduce_cols", "add_rms_norm_bwd",
               "norm_dw_reduce_kernel"))
    after_first = step_s[1:]
    med = float(np.median(after_first))
    emit({"train_times": {
        "card": card, "batch": batch, "tokens_per_step": tokens, "remat": remat,
        "step_s": [float(v) for v in step_s], "step_s_median_after_first": med,
        "tokens_per_s": tokens / med, "forward_s": float(split[0]), "backward_s": float(split[1]),
        "optimizer_s": float(split[2]), "peak_memory_gib": peak_gib,
        "device_busy_ms_per_step": profile["device_busy_ms_per_step"],
        "device_idle_share": profile["device_idle_share"],
        "kernel_launches_per_step": profile["kernel_launches_per_step"],
        "device_ms_per_step_by_kind": profile["device_ms_per_step_by_kind"],
        "top_kernels": profile["top_kernels"],
        # K5 (its kernel, then its two summing kernels), K1 (its tensor-core kernel,
        # then its multiply-add kernel), K6b (its kernel, then its dw sum) and K6a
        # (the same), device ms of the profiled step
        "named_ms_per_step": profile["named_ms_per_step"],
        "note": "host clock, each ending in a device synchronize; the split is the median of "
                "three hand-driven steps; idle share and kernels from one profiled step",
    }})

    # ---- what remat="proj" rests on: peak memory and time of one forward and
    # backward with and without checkpointing at two small batches ----
    peaks = []
    for b in (8, 16):
        sub = {k: v[:b] for k, v in flow.items()}
        for ck in (False, True):
            def fwd_bwd():
                loss = t2i_loss(params, model, sub["inputs"], sub["caption_ids"],
                                dtype=torch.bfloat16, generator=trainer.generator, remat=ck)
                torch.autograd.grad(loss, leaves, allow_unused=True)
            fwd_bwd()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            fwd_bwd()
            torch.cuda.synchronize()
            peaks.append({"batch": b, "tokens": b * TRAIN_LEN, "checkpointing": ck,
                          "seconds": time.time() - t0,
                          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "held_before_gib": base / 2**30})
    # the largest batch the rule still runs without checkpointing must fit
    edge = (REMAT_TOKENS - 1) // TRAIN_LEN
    if 16 < edge <= flow["inputs"].shape[0]:
        assert not resolve_remat("proj", edge * TRAIN_LEN)
        sub = {k: v[:edge] for k, v in flow.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        loss = t2i_loss(params, model, sub["inputs"], sub["caption_ids"], dtype=torch.bfloat16,
                        generator=trainer.generator, remat=False)
        torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        peaks.append({"batch": edge, "tokens": edge * TRAIN_LEN, "checkpointing": False,
                      "seconds": time.time() - t0, "largest_batch_below_the_rule": True,
                      "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
        del loss
    by = {(r["batch"], r["checkpointing"]): r for r in peaks}
    per_token = {ck: (by[(16, ck)]["peak_memory_gib"] - by[(8, ck)]["peak_memory_gib"])
                 / (8 * TRAIN_LEN) * 2**30 for ck in (False, True)}
    emit({"remat_threshold": {
        "card": card, "runs": peaks, "bytes_per_token_kept": per_token[False],
        "bytes_per_token_checkpointed": per_token[True], "rule_tokens": REMAT_TOKENS,
        "device_memory_gib": torch.cuda.get_device_properties(0).total_memory / 2**30,
    }})


def _paths(params):
    from omnimamba_tpu_torch.train.optimizer import named_leaves

    return list(named_leaves(params))


def _trains_in_align_t2i(path: str) -> bool:
    """Stage `align` with the t2i task only: what may move."""
    return ("lora" in path or any(s in path for s in (
        "img_embeddings", "caption_embed", "pos_embed", "embedding"))) and "mmu_pos_embed" not in path


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one CUDA device",
              file=sys.stderr)
        return 2
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    from omnimamba_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    info = kernel_build.build_kernels()
    kernel_build.load_kernels()
    emit({"build": {"seconds": info.seconds, "built": info.built, "library": info.library.name,
                    "commands": info.commands,
                    "ptxas": [ln for ln in info.log.splitlines() if "registers" in ln or "spill" in ln]}})

    results, phase_s = {"build_log": info.log}, {"build": time.time() - t_all}
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def phase(fn, *args):
        t = time.time()
        out = fn(*args)
        phase_s[fn.__name__] = time.time() - t
        return out

    for check in (check_ssd_scan, check_ssd_scan_bwd, check_ssd_step, check_norms, check_norms_bwd,
                  check_decode_fused, check_qmatmul, check_decode_fused_int8, check_ssd_step_int8):
        phase(check, gen, results)

    params, model, text_ids, bf16_tokens = phase(main_path, results, card)
    phase(fidelity_phase, params, model, text_ids, card)
    qmamba = phase(int8_path, params, model, text_ids, bf16_tokens, results, card)
    phase(slot_engine_phase, qmamba, model.cfg, card)
    phase(speculative_phase, params["mamba"], qmamba, model.cfg, card)
    del params, qmamba, bf16_tokens
    torch.cuda.empty_cache()
    phase(plain_vs_kernel)
    torch.cuda.empty_cache()
    phase(train_plain_vs_kernel)
    phase(train_path, results, card)

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (source, replaces) in KERNEL_FILES.items():
        r = results[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces}
        row.update({k: r[k] for k in keys})
        row.update({k: r[k] for k in (
            "case", "shape", "dtype", "bytes_moved", "host_us", "prefill", "fp32_state", "train",
            "train_b9", "kernel_name", "blocks_per_sm",
            "launches_fused_path", "launches_train", "launches_per_train_step", "flops",
            "chunk_states_bytes", "bound_with_states_ms", "ms_median_of_5_launches", "ptxas",
            "dynamic_smem_bytes", "sass",
            "library_note", "scan_step_device_ms", "ms_from_hbm", "row_kernel_ms_from_hbm",
            "copy_ms_from_hbm", "decode_rows", "parent_kernel_ms_from_hbm", "host_us_parts",
            "int8_state_step",
            "state_dtype_ms", "fused_against_scan_ms", "small_batch_profile", "prenorm_phase",
            "in_proj_phase", "ssm_phase", "out_proj_phase", "int8_in_proj_phase",
            "int8_out_proj_phase", "k4_phases",
            "layout",
            "out_dtype", "shapes", "launches_scan_path", "profile", "m_tile", "m_sweep")
                    if k in r})
        kernels.append(row)
    emit({"card": card, "seconds_total": time.time() - t_all, "seconds_by_phase": phase_s})
    emit({"kernels": kernels})  # measured on the card named in the line above
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What holds a hand-written kernel back: the kernel built with parts of its
work taken out, each build timed on the shapes of its main path.

    python3 tools/ablation.py [k5] [k7-decode] [k7-prefill] [k4-in-proj] [k4-in-proj-int8]
                              [k4-ssm] [k4-prenorm] [k4-out-proj] [k4-out-proj-int8] [k6b] [k2-q8]
                              [k3-decode]

needs one NVIDIA GPU and nvcc. For each target named (all if none is), it
builds the target's source once for each entry of its ``builds``, all builds
of all targets in parallel (a build that two targets share once), with the
target's measurement macro set to the entry's value, and times each build:

- ``k5`` (``ssd_scan_bwd.cu``, ``OMT_K5_SKIP``): K5's bf16 kernel through
  ``ssd_fused_bwd`` at one layer of the training step (B=90, L=328, H=64,
  P=64, N=128) and at B=9; then the shipped build with clusters of 8, 4 and 2
  heads (``BWD_BF16_CLUSTER``). Each time is the median of five single
  launches.
- ``k7-decode`` (``qmatmul.cu``, ``OMT_QMM_PAIR_SKIP``): K7's bf16 path below
  ``M_TILE`` rows at the 1.3B's decode shapes of ``chip_smoke.py`` at 48 rows,
  the step in_proj also at 16 rows and one row; each time the median of three
  calls of 20 launches.
- ``k7-prefill`` (``qmatmul.cu``, ``OMT_QMM_WIDE_SKIP``): K7's 128-row tiles at
  the prefill in_proj and out_proj at 3,456 rows and the in_proj at 1,024
  rows; each time one call of five launches.
- ``k4-in-proj`` (``decode_fused.cu``, ``OMT_K4_IN_SKIP``): K4's bf16 in_proj
  phase alone (``fused_decode_in_proj``: the product, the LoRA term, the conv
  step and the softplus), each launch on the next of the 1.3B's 48 layers, at
  16, 48 and 96 rows, beside the phase's bytes at the card's memory rate; each
  time the median of three calls of 96 launches; and the 48-layer step of
  each build (median of three calls of 5 steps), where the phase starts
  while the pre-norm runs.
- ``k4-in-proj-int8`` (the same builds): the same on ``quantize_decode_params``
  of the layers, whose int8 W_in takes the same pair kernel with its tiles
  widened in registers; the phase's bytes count W_in as int8 with its scale.
- ``k4-ssm`` (``decode_fused.cu``, ``OMT_K4_SSM_SKIP``): K4's SSM-update phase
  alone (``fused_decode_ssm``: the state update in place, y, the gate and the
  sums of squares), each launch on the next of the 1.3B's 48 layers, at 16, 48
  and 96 rows with a bf16 state, beside the phase's bytes at the card's memory
  rate; each time the median of three calls of 96 launches; and the 48-layer
  step of each build (median of three calls of 5 steps), where the phase
  starts while the in_proj runs.
- ``k4-prenorm`` (``decode_fused.cu``, ``OMT_K4_PRE_SKIP``): K4's bf16
  pre-norm phase alone (``fused_decode_prenorm``: the finished out_proj of
  the layer before, the residual add, the RMSNorm and hn @ A), each launch on
  the next of the 1.3B's 48 layers, at 16, 48 and 96 rows, beside the phase's
  bytes at the card's memory rate; each time the median of three calls of 96
  launches; and the 48-layer step of each build (median of three calls of 5
  steps), where the phase starts while the out_proj runs and the in_proj
  while it runs.
- ``k4-out-proj`` (``decode_fused.cu``, ``OMT_K4_OUT_SKIP``): K4's bf16
  out_proj phase alone (``fused_decode_out_proj``: the product of the gated,
  weighted yf with W_out into the fp32 K-split partials), each launch on the
  next of the 1.3B's 48 layers, at 16, 48 and 96 rows, beside the phase's
  bytes at the card's memory rate; each time the median of three calls of 96
  launches; and the 48-layer step of each build (median of three calls of 5
  steps), where the phase starts while the SSM update ends.
- ``k4-out-proj-int8`` (the same builds): the
  same on ``quantize_decode_params`` of the layers, whose int8 W_out takes the
  same pair kernel with its tiles widened in registers; the phase's bytes
  count W_out as int8 with its scale.
- ``k6b`` (``norms.cu``, ``OMT_K6B_SKIP``): K6b, the gated norm's backward,
  through ``fused_gated_rms_norm_bwd`` at one layer of the training step
  (90 x 328 rows of 4096, bf16, z a column slice) and at B=9; each time the
  median of five single launches, beside the bytes at the card's memory
  rate, and the device time of the row pass and of the dw sum (profiler, five
  launches); then the parent kernel (build 32) with a grid of 396 blocks, one
  wave at three an SM (other dw bits). Build 32 sends every shape to the
  parent kernel; its dy, dz and dw, and those of the other builds that keep
  the bits, must equal the library's bit for bit at every case of
  ``chip_smoke.GATED_BWD_CASES`` that the row kernel takes, which is
  asserted.
- ``k2-q8`` (``ssd_step.cu``, ``OMT_K2_Q8_SKIP``): K2's int8-state branch
  through ``ssd_step_fused`` (bf16 x, H=64, P=64, G=1, N=128) at B = 16, 48
  and 96, each launch on the next of 48 layers' states so that q comes from
  device memory; each time the median of three calls of 96 launches, beside
  the bytes at the card's memory rate and a ``copy_`` of the same q and scale
  bytes; the shipped build is read again after the others, for the spread.
  Builds 8, 32 (the parent kernel for every shape), 64, 128, 256, 512 and
  1024 keep the bits: their q, scale and y, and the shipped build's, must
  equal the library's bit for bit at each B, which is asserted. Then
  ``tools/q8_div_check.cu`` holds the tile kernel's division and rounding
  against the parent's for every fp32 dividend up to 128 times each of 256
  divisors in its fast range (and four outside it), asserting no
  disagreement in the range.
- ``k3-decode`` (``norms.cu``, ``OMT_K3_SKIP``): K3a (d = 2048, fp32 residual)
  and K3b (d = 4096, z a column slice) through ``fused_add_rms_norm`` and
  ``fused_gated_rms_norm`` at decode's 48 rows of bf16 with bf16 weights, each
  launch on the next of 48 inputs; each time the median of three calls of 96
  launches back to back and of three medians of 96 single launches
  (``chip_smoke.time_alone_ms``), beside the bytes at the card's memory rate;
  the shipped build is read again after the others; then build 64 (no cutoff
  of rows) against build 16 (the parent kernels for every shape) at 256 to
  2,048 rows, each launch on the next of 48 inputs, build 64 read before and
  after build 16, each reading timed both ways. Builds 2, 4, 16 and 64 keep
  the bits: their out and y, and the shipped build's, must equal the
  library's, which is asserted.

Of every ``k4-*`` build the phase is also timed one launch at a time, with
nothing beside it (``phase_one_launch_ms``: ``chip_smoke.time_alone_ms``, the
median of 96), and the 48-layer step is profiled (3 steps,
``tools/k4_probe.py``'s ``profile``): each phase's time that no earlier kernel
overlaps, and how long after the end of the kernels ahead of it the phase's
kernel starts (negative: while they run).

Only the build with the value 0 (and, of ``k4-in-proj`` and
``k4-in-proj-int8``, 32, 64 and 128, of ``k4-ssm`` 4, 8, 32 and 64, of
``k4-prenorm`` 16, 32, 64 and 256, of ``k4-out-proj`` 32, 64, 128, 256,
512 and 1024 and of ``k4-out-proj-int8`` the same, which change when work
starts, not what it computes; of ``k6b`` 32, 64, 128, 256 and 1024, which
change the kernel, when bytes are asked for, how often the sigmoid is
computed or which kernel sums dw; of ``k2-q8`` 8, 32, 64, 128, 256, 512 and 1024, which change
how the same values are computed, by which kernel, in how many passes, with
or without a prefetch, at four or five blocks an SM) gives
correct results; the build with 0 must equal the library's bits, which is
asserted, and so must each ``k4-in-proj-int8``, ``k4-out-proj``,
``k4-out-proj-int8``, ``k6b`` and ``k2-q8`` build of that list (on the same
inputs, restored before each check). Prints
the card, one JSON line a measurement, then one JSON line of all with each
build's ``ptxas`` lines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

_bf, _f32 = torch.bfloat16, torch.float32


def median_ms(fn, repeats: int, iters: int, warmup: int = 3) -> float:
    """The median of `repeats` device times (ms a call) of `iters` calls."""
    import chip_smoke as cs

    return statistics.median(cs.time_ms(fn, iters, warmup) for _ in range(repeats))


def emit(rows: dict, key, rec) -> None:
    rows[key] = rec
    print(json.dumps({key: rec}), flush=True)


def only(entry: str, fn):
    """The library's wrappers see `fn` as its function `entry`, and the shipped
    library's others, while inside."""
    import chip_smoke as cs

    return cs.only(entry, fn)


def run_k5(libs: dict, builds: dict, rows: dict) -> None:
    import chip_smoke as cs
    from omnimamba_tpu_torch.ops import ssd_kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for batch in (cs.TRAIN_BATCH, cs.TRAIN_BATCH // 10):
        x, dt, A, Bm, Cm, D = cs.ssd_inputs(gen, batch, cs.TRAIN_LEN, 64, 64, 1, 128, _bf)
        gy = cs.rand(gen, x.shape, _bf)
        _, _, hin = sk.ssd_fused(x, dt, A, Bm, Cm, D, return_chunk_states=True)

        def run():
            return sk.ssd_fused_bwd(x, dt, A, Bm, Cm, D, hin, gy)

        want = run()
        for v, name in builds.items():
            with only("omt_ssd_scan_bwd", libs[v]):
                if v == 0:
                    assert all(torch.equal(g, w) for g, w in zip(run(), want) if w is not None)
                emit(rows, f"B{batch} {name}", median_ms(run, 5, 1, 1))
        if batch == cs.TRAIN_BATCH:  # the cluster size, through the shipped build
            shipped = sk.BWD_BF16_CLUSTER
            try:
                for cluster in (8, 4, 2):
                    sk.BWD_BF16_CLUSTER = cluster
                    emit(rows, f"B{batch} cluster of {cluster}", median_ms(run, 5, 1, 1))
            finally:
                sk.BWD_BF16_CLUSTER = shipped


def run_k4_phase(phase: str, same_bits=(), int8=False):
    """K4's bf16 `phase` ("prenorm", "in_proj", "ssm" or "out_proj") through each
    build: the phase alone, each launch on the next of the 48 layers, and the
    48-layer step; with `int8` on the layers' `quantize_decode_params` (int8
    in_proj and out_proj). The builds 0 and `same_bits` must give the
    library's bits."""

    def run(libs: dict, builds: dict, rows: dict) -> None:
        import chip_smoke as cs
        import k4_probe
        from omnimamba_tpu_torch.config import LoraConfig, Mamba2LayerConfig
        from omnimamba_tpu_torch.ops import decode_fused as df
        from omnimamba_tpu_torch.ops.quant import quantize_decode_params

        cfg, lcfg = Mamba2LayerConfig(), LoraConfig()
        launch = {"prenorm": df.fused_decode_prenorm, "in_proj": df.fused_decode_in_proj,
                  "ssm": df.fused_decode_ssm, "out_proj": df.fused_decode_out_proj}[phase]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        layers = cs.fused_layers(gen, 48, cfg, lcfg, _bf)
        if int8:
            layers = quantize_decode_params({"layers": layers})["layers"]
        for batch in (16, cs.BATCH, 2 * cs.BATCH):
            h = cs.rand(gen, (batch, cfg.d_model), _bf)
            residual = cs.rand(gen, (batch, cfg.d_model), _f32)  # the pre-norm's, in place
            cache = cs.fused_state(gen, len(layers), batch, cfg, _bf, _bf)
            plan = df.prepare_fused_decode(layers, "t2i", cfg, lcfg, batch, _bf)
            args = (layers, h, None, cache, "t2i", cfg, lcfg, 1e-5)
            df.fused_decode_step(*args, plan=plan)  # the scratch holds real inputs of the phase
            phase_args = (layers, h, residual, *args[3:]) if phase == "prenorm" else args
            turn = [0]

            def alone():  # each launch on the next layer: its weights and state come from memory
                launch(*phase_args, plan=plan, layer=turn[0] % len(layers))
                turn[0] += 1

            # what the checked layer's phase writes: the residual, hn and hn @ A
            # (layer 1: from the out_proj's partials); or z, x B C and dt after
            # the conv step and softplus and the rolled window; or the new
            # state, yf * w_gn and the sums of yf^2 (layer 0); or the fp32
            # K-split partials (layer 0)
            at = 1 if phase == "prenorm" else 0
            if phase == "prenorm":
                written = [residual] + [plan.scratch[k] for k in ("hn", "hA")]
            elif phase == "in_proj":
                written = [plan.scratch[k] for k in ("z", "xbc", "dt")] + [cache.conv_state]
            elif phase == "out_proj":
                written = [plan.scratch["part"]]
            else:
                written = [cache.ssm_state[0]] + [plan.scratch[k] for k in ("ya", "sumsq")]
            # what the phase reads and updates in place, as the library's step
            # left it: restored before each check (a build with work taken out
            # runs the step with wrong, even non-finite, results)
            read = list(plan.scratch.values()) + [cache.conv_state[at], cache.ssm_state[at],
                                                  residual]
            saved = [t.clone() for t in read]

            def restore():
                for t, s in zip(read, saved):
                    t.copy_(s)

            phase_bytes = cs.k4_phase_bytes(cfg, lcfg.r, batch, proj_bytes=1 if int8 else None)
            bound = phase_bytes[f"k4_{phase}"] / cs.HBM_BYTES_PER_S * 1e3
            rec = {"shape": {"prenorm": (batch, cfg.d_model, lcfg.r),
                             "in_proj": (batch, cfg.d_model, cfg.d_in_proj),
                             "ssm": (batch, cfg.nheads, cfg.headdim, cfg.d_state),
                             "out_proj": (batch, cfg.d_inner, cfg.d_model)}[phase],
                   "bound_ms": bound, "bound_by": "bytes", "phase_ms": {}, "phase_one_launch_ms": {},
                   "step_ms": {},
                   "step_exposed_ms": {}, "step_start_after_ahead_end_us": {}}
            for v, name in builds.items():
                if v == 0 or v in same_bits:  # the library's outputs
                    restore()
                    launch(*phase_args, plan=plan, layer=at)
                    want = [t.clone() for t in written]
                with only("omt_fused_decode_step", libs[v]):
                    if v == 0 or v in same_bits:  # the build's on the same inputs, bit for bit
                        restore()
                        if phase == "out_proj":  # NaN where the build does not write
                            plan.scratch["part"].view(torch.uint8).fill_(0xFF)
                        launch(*phase_args, plan=plan, layer=at)
                        torch.cuda.synchronize()
                        assert all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
                                   for g, w in zip(written, want)), \
                            f"the build {name!r} differs from the library at B={batch}"
                        del want
                    rec["phase_ms"][name] = median_ms(alone, 3, 2 * len(layers))
                    rec["phase_one_launch_ms"][name] = cs.time_alone_ms(alone, 2 * len(layers))
                    rec["step_ms"][name] = median_ms(lambda: df.fused_decode_step(*args, plan=plan),
                                                     3, 5)
                    prof = k4_probe.profile(lambda: df.fused_decode_step(*args, plan=plan))
                    rec["step_exposed_ms"][name] = prof["exposed_ms_per_step"]
                    rec["step_start_after_ahead_end_us"][name] = prof["start_after_ahead_end_us"]
            emit(rows, f"{phase}{'_int8' if int8 else ''}_B{batch}", rec)
            del cache, plan, written, read, saved, residual

    return run


def run_k6b(libs: dict, builds: dict, rows: dict) -> None:
    import chip_smoke as cs
    from omnimamba_tpu_torch.ops import norms_kernel as nk

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for name, lead, d, dtype, wdtype, timed, beside, row_kernel in cs.GATED_BWD_CASES:
        if not row_kernel:
            continue
        y, z, g, w = cs.gated_bwd_inputs(gen, lead, d, dtype, wdtype, beside)

        def run():
            return nk.fused_gated_rms_norm_bwd(y, z, g, w, 1e-5)

        want = run()  # the library's
        for v in (0, 32, 64, 128, 256, 1024):  # the shipped build and those keeping its bits
            with only("omt_gated_rms_norm_bwd", libs[v]):
                assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                           for a, b in zip(run(), want)), f"build {v} differs at {name}"
        rec = {"shape": (*lead, d), "weight_dtype": str(wdtype), "z_row_stride": z.stride(-2),
               "bits_equal_to_the_parent_kernel": True}
        del want
        if timed:
            rec.update(bound_ms=cs.nbytes(y, z, g, w, *run()) / cs.HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes", ms={}, row_pass_ms={}, dw_sum_ms={})
            for v, build in builds.items():
                with only("omt_gated_rms_norm_bwd", libs[v]):
                    rec["ms"][build] = median_ms(run, 5, 1, 1)
                    split = cs.profile_steps(lambda i: run(), 5, top=4, named=(
                        "gated_rms_norm_bwd", "norm_dw_reduce"))["named_ms_per_step"]
                    rec["row_pass_ms"][build] = split["gated_rms_norm_bwd"]
                    rec["dw_sum_ms"][build] = split["norm_dw_reduce"]
            shipped = nk.BWD_BLOCKS
            try:  # the parent kernel in one wave at three blocks an SM (other dw bits)
                nk.BWD_BLOCKS = 3 * torch.cuda.get_device_properties(0).multi_processor_count
                with only("omt_gated_rms_norm_bwd", libs[32]):
                    rec["ms"][f"the parent kernel, {nk.BWD_BLOCKS} blocks"] = median_ms(run, 5, 1, 1)
            finally:
                nk.BWD_BLOCKS = shipped
        emit(rows, name, rec)


def run_k2_q8(libs: dict, builds: dict, rows: dict) -> None:
    import chip_smoke as cs
    from omnimamba_tpu_torch.ops.quant import quantize_ssm_state
    from omnimamba_tpu_torch.ops.ssd_step_kernel import ssd_step_fused

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    H, P, G, N = 64, 64, 1, 128
    for B in (16, cs.BATCH, 96):
        x, dt, A, Bm, Cm, D = cs.ssd_inputs(gen, B, 1, H, P, G, N, _bf, True)
        x, dt, Bm, Cm = x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0]
        state0 = quantize_ssm_state(cs.rand(gen, (B, H, P, N), _f32, 0.5))

        def run(state):
            return ssd_step_fused(x, dt, A, Bm, Cm, D, state)

        fresh = {k: v.clone() for k, v in state0.items()}
        y_want = run(fresh)[0]  # the library's
        for v in (0, 8, 32, 64, 128, 256, 512, 1024):  # the builds that keep the bits
            st = {k: t.clone() for k, t in state0.items()}
            with only("omt_ssd_step_q8", libs[v]):
                y = run(st)[0]
            assert all(cs.bits_equal(a, b) for a, b in (
                (y, y_want), (st["q"], fresh["q"]), (st["scale"], fresh["scale"]))), (
                f"build {v} differs at B={B}")
        moved = cs.nbytes(x, dt, A, Bm, Cm, D, y_want) + 2 * cs.nbytes(state0["q"], state0["scale"])
        layers = [{k: t.clone() for k, t in state0.items()} for _ in range(cs.STATE_LAYERS)]
        turn = iter(range(1 << 30))

        def step():
            return run(layers[next(turn) % cs.STATE_LAYERS])

        def copy():
            i = next(turn)
            src = layers[i % cs.STATE_LAYERS]
            dst = layers[(i + cs.STATE_LAYERS // 2) % cs.STATE_LAYERS]
            dst["q"].copy_(src["q"])
            dst["scale"].copy_(src["scale"])

        iters = 2 * cs.STATE_LAYERS
        rec = {"shape": (B, H, P, G, N), "x_dtype": str(_bf), "bytes_moved": moved,
               "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "bits_equal_to_the_library": [0, 8, 32, 64, 128, 256, 512, 1024], "ms": {},
               "copy_ms": median_ms(copy, 3, iters)}
        for v, build in builds.items():
            for layer in layers:  # each build from the same states
                layer["q"].copy_(state0["q"])
                layer["scale"].copy_(state0["scale"])
            with only("omt_ssd_step_q8", libs[v]):
                rec["ms"][build] = median_ms(step, 3, iters)
        with only("omt_ssd_step_q8", libs[0]):  # the spread between readings of one build
            rec["ms"]["as shipped, again"] = median_ms(step, 3, iters)
        del layers
        emit(rows, f"B={B}", rec)
    emit(rows, "division", q8_division_check(gen))


def run_k3_decode(libs: dict, builds: dict, rows: dict) -> None:
    import chip_smoke as cs
    from omnimamba_tpu_torch.ops import norms_kernel as nk

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for kind, d, variant in (("add", 2048, "residual"), ("gated", 4096, "z_slice")):
        fn = nk.fused_add_rms_norm if kind == "add" else nk.fused_gated_rms_norm
        layers = [cs.norm_rows_inputs(gen, kind, cs.BATCH, d, _bf, variant)
                  for _ in range(cs.STATE_LAYERS)]
        turn = iter(range(1 << 30))

        def call():
            return fn(*layers[next(turn) % cs.STATE_LAYERS], 1e-5)

        want = [cs._as_tuple(fn(*args, 1e-5)) for args in layers[:4]]  # the library's
        for v in (0, 2, 4, 16, 64):  # the builds that keep the bits
            with cs.parent_norms(libs[v]):
                got = [cs._as_tuple(fn(*args, 1e-5)) for args in layers[:4]]
            assert all(cs.bits_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w)), (
                f"build {v} differs for {kind}")
        outs = want[0]
        moved = cs.nbytes(layers[0][0], layers[0][2], *outs) + layers[0][1].numel() * (
            2 if kind == "gated" else 4)
        n = 2 * cs.STATE_LAYERS
        rec = {"rows": cs.BATCH, "d": d, "variant": variant, "bytes_moved": moved,
               "bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "bits_equal_to_the_library": [0, 2, 4, 16, 64], "ms": {}, "ms_alone": {}}
        for v, build in builds.items():
            with cs.parent_norms(libs[v]):
                rec["ms"][build] = median_ms(call, 3, n)
                rec["ms_alone"][build] = statistics.median(cs.time_alone_ms(call, n) for _ in range(3))
        with cs.parent_norms(libs[0]):  # the spread between readings of one build
            rec["ms"]["as shipped, again"] = median_ms(call, 3, n)
        del layers
        emit(rows, "K3a" if kind == "add" else "K3b", rec)

        # where the decode-rows kernel stops beating the parent: build 64 (no
        # cutoff) against build 16 (the parent) from 256 rows up
        rec = {"d": d, "variant": variant, "ms": {}, "ms_alone": {}}
        for n_rows in (256, 384, 512, 640, 768, 1024, 2048):
            layers = [cs.norm_rows_inputs(gen, kind, n_rows, d, _bf, variant)
                      for _ in range(cs.STATE_LAYERS)]

            def call_rows():
                return fn(*layers[next(turn) % cs.STATE_LAYERS], 1e-5)

            rec["ms"][n_rows], rec["ms_alone"][n_rows] = {}, {}
            for v in (64, 16, 64):
                with cs.parent_norms(libs[v]):
                    rec["ms"][n_rows].setdefault(builds[v], []).append(median_ms(call_rows, 3, n))
                    rec["ms_alone"][n_rows].setdefault(builds[v], []).append(
                        statistics.median(cs.time_alone_ms(call_rows, n) for _ in range(3)))
            del layers
        emit(rows, f"{'K3a' if kind == 'add' else 'K3b'} rows", rec)


def q8_division_check(gen) -> dict:
    """``tools/q8_div_check.cu``: the tile kernel's division and rounding
    against the parent's ``__float2int_rn(a / b)`` for every fp32 a with
    |a| <= 128 b, at divisors b in the tile kernel's fast range [2^-72, 2^72]
    (its edges, 1e-20, the scale of a row of zeros, and random ones) and a
    few outside it, where the kernel takes the parent's code; the range must
    give no disagreement, which is asserted."""
    import chip_smoke as cs
    from omnimamba_tpu_torch.ops import kernel_build as kb

    lib = kb.BUILD_DIR / "ablation" / "lib_q8_div_check.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kb._find_nvcc(), *kb.NVCC_FLAGS, "-shared", f"-I{kb.CSRC_DIR}", "-o", str(lib),
                    str(ROOT / "tools" / "q8_div_check.cu")], check=True, capture_output=True)
    check = ctypes.CDLL(str(lib)).omt_q8_div_check
    check.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    edges = [2.0 ** -72, 2.0 ** 72, 1e-20, 1.0, 3.0, 1.0 / 127.0]
    drawn = torch.exp2(torch.rand(250, generator=gen, device="cuda", dtype=torch.float64) * 144 - 72)
    inside = torch.cat([torch.tensor(edges, device="cuda", dtype=torch.float64), drawn]).float()
    inside = inside.clamp(2.0 ** -72, 2.0 ** 72)
    outside = torch.tensor([2.0 ** -100, 2.0 ** -90, 2.0 ** 90, 2.0 ** 110], device="cuda")
    bs = torch.cat([inside, outside])
    bad = torch.zeros(len(bs), dtype=torch.int64, device="cuda")
    first = torch.zeros(len(bs), dtype=torch.int32, device="cuda")
    t0 = time.time()
    err = check(bs.data_ptr(), len(bs), bad.data_ptr(), first.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    kb.check_launch(err, "q8 division check")
    torch.cuda.synchronize()
    n = len(inside)
    rec = {"divisors_in_range": n, "dividends_each": "every fp32 a with |a| <= 128 b",
           "disagreements_in_range": int(bad[:n].sum()),
           "outside": {f"{b:.3g}": int(c) for b, c in zip(outside.tolist(), bad[n:].tolist())},
           "seconds": time.time() - t0}
    assert rec["disagreements_in_range"] == 0, (rec, bs[:n][bad[:n] > 0].tolist(),
                                                first[:n][bad[:n] > 0].tolist())
    return rec


# name -> (rows, K, O, (O, K) table, out dtype)
K7_DECODE_SHAPES = {
    "step_in_proj": (48, 2048, 8512, False, _bf),
    "step_out_proj": (48, 4096, 2048, False, _bf),
    "project_in_fc1": (48, 2048, 8192, False, _bf),
    "project_in_fc2": (48, 8192, 2048, False, _bf),
    "project_in_fc3": (48, 2048, 2048, False, _bf),
    "image_head": (48, 2048, 16384, True, _f32),
    "step_in_proj_16_rows": (16, 2048, 8512, False, _bf),
    "step_in_proj_one_row": (1, 2048, 8512, False, _bf),
}
K7_PREFILL_SHAPES = {
    "prefill_in_proj": (3456, 2048, 8512, False, _bf),
    "prefill_out_proj": (3456, 4096, 2048, False, _bf),
    "slot_prefill_in_proj": (1024, 2048, 8512, False, _bf),
}


def run_k7(path: str, m_tile: int, shapes: dict, repeats: int, iters: int):
    """K7's `path`, forced by its M_TILE `m_tile`, through each build at `shapes`."""

    def run(libs: dict, builds: dict, rows: dict) -> None:
        import chip_smoke as cs
        from omnimamba_tpu_torch.ops import kernel_build as kb
        from omnimamba_tpu_torch.ops.quant import quantize_linear
        from omnimamba_tpu_torch.ops.quant_kernel import qmatmul

        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        for shape, (M, K, O, tr, od) in shapes.items():
            w = cs.rand(gen, (O, K) if tr else (K, O), _f32, 0.02)
            qe = quantize_linear(w, (1,) if tr else (0,))
            q, sc = qe["q"], qe["scale"]
            x = cs.rand(gen, (M, K), _bf)
            y = torch.empty((M, O), dtype=od, device="cuda")

            def launch(omt_qmatmul):
                err = omt_qmatmul(x.data_ptr(), q.data_ptr(), sc.data_ptr(), y.data_ptr(), M, K, O,
                                  int(tr), kb.BF16, kb.dtype_code(od), m_tile,
                                  torch.cuda.current_stream().cuda_stream)
                kb.check_launch(err, "qmatmul ablation")

            with cs._m_tile(m_tile):
                want = qmatmul(x, q, sc, tr, od)
            launch(libs[0])
            torch.cuda.synchronize()
            assert torch.equal(y, want), f"the shipped build differs at {shape}"
            bytes_ms = cs.nbytes(x, q, sc, y) / cs.HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * M * K * O / cs.PEAK_OPS[_bf] * 1e3
            rec = {"path": path, "shape": (M, K, O), "layout": "(O, K)" if tr else "(K, O)",
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            for v, name in builds.items():
                rec[name] = median_ms(lambda: launch(libs[v]), repeats, iters)
            emit(rows, shape, rec)

    return run


# source (under omnimamba_tpu_torch/csrc), entry function, measurement macro,
# builds (macro value -> name; 0 is the shipped build), run(libs, builds, rows)
# where libs maps a macro value to its build's entry function
TARGETS = {
    "k5": ("ssd_scan_bwd.cu", "omt_ssd_scan_bwd", "OMT_K5_SKIP",
           {0: "as shipped", 1: "no state copies", 2: "no pushes", 8: "no sums of pushed rows",
            10: "no cluster sums", 4: "no W products", 15: "none of these"},
           run_k5),
    "k7-decode": ("qmatmul.cu", "omt_qmatmul", "OMT_QMM_PAIR_SKIP",
                  {0: "as shipped", 1: "no activation copies", 2: "no weight copies",
                   3: "no copies", 4: "no widening or products",
                   7: "launch, barriers and stores only", 8: "launch only"},
                  run_k7("decode", 1 << 30, K7_DECODE_SHAPES, 3, 20)),
    "k7-prefill": ("qmatmul.cu", "omt_qmatmul", "OMT_QMM_WIDE_SKIP",
                   {0: "as shipped", 1: "no widening", 2: "no copies",
                    3: "products and ldmatrix only"},
                   run_k7("prefill", 1, K7_PREFILL_SHAPES, 1, 5)),
    "k4-in-proj": ("decode_fused.cu", "omt_fused_decode_step", "OMT_K4_IN_SKIP",
                   {0: "as shipped", 1: "no activation copies", 2: "no weight copies",
                    3: "no copies", 4: "no products", 8: "no epilogue",
                    7: "launch, barriers and epilogue only", 15: "launch and barriers only",
                    16: "launch only", 32: "no weights before the pre-norm ends",
                    64: "ordinary launch", 128: "no L2 prefetch for the epilogue"},
                   run_k4_phase("in_proj")),
    "k4-in-proj-int8": ("decode_fused.cu", "omt_fused_decode_step", "OMT_K4_IN_SKIP",
                        {0: "as shipped", 1: "no activation copies", 2: "no weight copies",
                         3: "no copies", 4: "no widening or products", 8: "no epilogue",
                         16: "launch only", 32: "no weights before the pre-norm ends",
                         64: "ordinary launch", 128: "no L2 prefetch for the epilogue"},
                        run_k4_phase("in_proj", same_bits=(32, 64, 128), int8=True)),
    "k4-ssm": ("decode_fused.cu", "omt_fused_decode_step", "OMT_K4_SSM_SKIP",
               {0: "as shipped", 1: "no state loads", 2: "no state stores",
                3: "no state traffic", 16: "launch only", 4: "ordinary launch",
                8: "no early start", 32: "state loads after the wait",
                64: "early start near the in_proj's end"},
               run_k4_phase("ssm")),
    "k4-prenorm": ("decode_fused.cu", "omt_fused_decode_step", "OMT_K4_PRE_SKIP",
                   {0: "as shipped", 1: "no partial or sumsq reads", 2: "no norm-weight or A reads",
                    4: "no hn @ A", 7: "none of these", 8: "launch only", 16: "ordinary launch",
                    32: "in_proj may start at entry", 64: "in_proj may start once hn is written",
                    256: "in_proj may start after the first barrier"},
                   run_k4_phase("prenorm")),
    "k4-out-proj": ("decode_fused.cu", "omt_fused_decode_step", "OMT_K4_OUT_SKIP",
                    {0: "as shipped", 1: "no activation copies", 2: "no weight copies",
                     3: "no copies", 4: "no products", 8: "no exchange or stores",
                     7: "launch, barriers and stores only", 15: "launch and barriers only",
                     16: "launch only", 32: "ordinary launch",
                     64: "no weights before the SSM update ends",
                     128: "SSM lets it start at entry", 256: "SSM lets it start after its stores",
                     512: "SSM lets it start only as it ends", 1024: "no pre-norm trigger"},
                    run_k4_phase("out_proj", same_bits=(32, 64, 128, 256, 512, 1024))),
    "k6b": ("norms.cu", "omt_gated_rms_norm_bwd", "OMT_K6B_SKIP",
            {0: "as shipped", 1: "no input loads", 2: "no dy / dz stores",
             4: "no second-pass arithmetic", 8: "no sigmoid", 28: "loads and stores only",
             23: "launch and barriers only", 64: "the next row asked for a row ahead",
             128: "sigmoid again in the second pass", 256: "no L2 prefetch of g",
             1024: "the parent's dw sum", 32: "the parent kernel for every shape"},
            run_k6b),
    "k3-decode": ("norms.cu", ("omt_add_rms_norm", "omt_gated_rms_norm"), "OMT_K3_SKIP",
                  {0: "as shipped", 1: "launch only", 2: "no weight prefetch",
                   4: "ordinary launch", 64: "no row cutoff", 16: "the parent kernel"},
                  run_k3_decode),
    "k2-q8": ("ssd_step.cu", "omt_ssd_step_q8", "OMT_K2_Q8_SKIP",
              {0: "as shipped", 1: "no state loads", 2: "no state stores",
               4: "no requantize arithmetic", 8: "the conversions through I2F / F2I / `/`",
               16: "launch only", 64: "eight rows a pass", 128: "no L2 prefetch of the next wave",
               256: "five blocks an SM", 512: "the widening alone through I2F",
               1024: "N at run time",
               32: "the parent kernel for every shape"},
              run_k2_q8),
}
TARGETS["k4-out-proj-int8"] = (
    *TARGETS["k4-out-proj"][:4],
    run_k4_phase("out_proj", same_bits=(32, 64, 128, 256, 512, 1024), int8=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("targets", nargs="*", help=f"{', '.join(TARGETS)} (default: all)")
    targets = ap.parse_args().targets or list(TARGETS)
    if set(targets) - set(TARGETS):
        ap.error(f"targets are {', '.join(TARGETS)}")
    if not torch.cuda.is_available():
        print("ablation: needs one CUDA device", file=sys.stderr)
        return 2
    from omnimamba_tpu_torch.ops import kernel_build as kb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = kb.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kb._find_nvcc()
    procs = {}  # (source, macro, value) -> the build
    for t in targets:
        source, _, macro, builds, _ = TARGETS[t]
        for v in builds:
            if (source, macro, v) in procs:
                continue
            lib = out_dir / f"lib_{macro}_{v}.so"
            cmd = [nvcc, *kb.NVCC_FLAGS, "-shared", f"-D{macro}={v}", "-o", str(lib),
                   str(kb.CSRC_DIR / source)]
            procs[source, macro, v] = lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                            stderr=subprocess.STDOUT, text=True)
    shipped = kb.load_kernels()
    built, ptxas = {}, {}
    for (source, macro, v), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {macro}={v}:\n{log}")
        ptxas[f"{macro}={v}"] = sorted(
            {ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln})
        built[source, macro, v] = ctypes.CDLL(str(lib))
    libs = {t: {} for t in targets}
    for t in targets:
        source, entry, macro, builds, _ = TARGETS[t]
        for v in builds:
            fns = {}
            for e in entry if isinstance(entry, tuple) else (entry,):
                fns[e] = getattr(built[source, macro, v], e)
                fns[e].argtypes = getattr(shipped, e).argtypes
                fns[e].restype = getattr(shipped, e).restype
            # a target of one entry gets its function; one of several, them by name
            libs[t][v] = fns if isinstance(entry, tuple) else fns[entry]

    rows = {}
    for t in targets:
        _, _, _, builds, run = TARGETS[t]
        rows[t] = {}
        run(libs[t], builds, rows[t])
    print(json.dumps({"card": card, "ablation_ms": rows, "ptxas": ptxas,
                      "builds": {t: {TARGETS[t][2]: TARGETS[t][3]} for t in targets}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

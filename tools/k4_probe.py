"""K4 (the whole-model decode step) of one checkout of the port, on the card:
the bits of its outputs on fixed inputs and its device time by phase, so that
two checkouts (a change and its parent) can be held against each other in
one call.

    python3 tools/k4_probe.py --root DIR --out FILE
    python3 tools/k4_probe.py --compare FILE_A FILE_B

needs one NVIDIA GPU and nvcc. The first form imports the port and
`chip_smoke.py` from DIR (a checkout, for example `git archive` of a parent
unpacked into a git-ignored directory), makes the 1.3B's 48 random bf16
layers and inputs from the seed of `chip_smoke.py`, and:

- saves h, the residual, the conv windows and the SSM states after one step
  through 1 layer and through 48 layers at B=48, and through 1 layer at B=96
  (bf16 state, LoRA rank 8, task t2i), through 48 layers at B=16 with an fp32
  state, and on `quantize_decode_params` of the layers (int8 in_proj and
  out_proj) through 48 layers at B=48 and through 1 layer at B = 16 and 96,
  to FILE;
- times the 48-layer step (CUDA events around 10 queued steps) and the
  host's time to enqueue a step (median of five calls of 3 steps queued
  behind other work), and profiles 3 steps (queued behind other work) at
  B = 16, 48 and 96 with the time of each of K4's phase kernels, the part of it that no earlier kernel overlaps (the
  bf16 pre-norm starts while the out_proj runs, the in_proj while the
  pre-norm runs, the SSM update while the in_proj runs) and how long after
  the end of the kernels ahead of it each starts; at those batches also the
  pre-norm phase alone (`fused_decode_prenorm`) and the out_proj phase alone
  (`fused_decode_out_proj`), each of 96 launches on the next layer, back to
  back (`_alone_ms`) and each with nothing beside it (`_one_launch_ms`; null
  for a checkout that has no such function), beside `torch.matmul(ya, W_out)`
  on the same bf16 operands and layers;
- does the same with an fp32 state at B = 8 and 16, and at B = 16, 48 and 96
  on the int8 layers, there with the in_proj and out_proj phases alone
  (`fused_decode_in_proj`, `fused_decode_out_proj`) in place of the bf16
  phases, the out_proj beside `torch.matmul(ya, q as bf16)`;
- writes the SASS of each of K4's kernels in the checkout's library
  (`cuobjdump -sass`, addresses and encodings taken out, branch labels and
  internal subroutines numbered in order within each kernel) to
  FILE.sass.json, by name.

Prints the card, then one JSON line. The second form asserts that every saved
tensor of A equals B's bit for bit and prints one JSON line; where both
FILE.sass.json exist, it also names each of A's K4 kernels whose SASS a
kernel of B has, those whose SASS none has, and of these, where B has a
kernel of the same name, the first instruction that differs.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PHASES = ("k4_prenorm", "k4_in_proj", "k4_ssm", "k4_out_proj", "k4_finish")


def profile(step, steps: int = 3) -> dict:
    """Device ms a step of each phase kernel, summed and exposed (not
    overlapped by an earlier kernel), and the mean µs from the end of the
    kernels ahead of a phase's kernel to its start (negative: it started
    while they ran), from a profiler trace of `steps` steps queued behind
    other work, so that the host's time to enqueue them (longer under the
    profiler) does not leave the device waiting between kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import chip_smoke as cs

    step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs._occupy_device(50.0)
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    summed = dict.fromkeys(PHASES, 0.0)
    exposed = dict.fromkeys(PHASES, 0.0)
    leads = {key: [] for key in PHASES}
    last_end = float("-inf")
    for start, end, name in sorted((e.time_range.start, e.time_range.end, e.name)
                                   for e in prof.events() if e.device_type == DeviceType.CUDA):
        for key in PHASES:
            if key in name:
                summed[key] += (end - start) / 1e3 / steps
                exposed[key] += max(0.0, end - max(start, last_end)) / 1e3 / steps
                if last_end > float("-inf"):
                    leads[key].append(start - last_end)  # µs
        last_end = max(last_end, end)
    return {"ms_per_step": summed, "exposed_ms_per_step": exposed,
            "start_after_ahead_end_us": {k: sum(v) / len(v) for k, v in leads.items() if v}}


def k4_sass(library: Path, match: str = "k4_") -> dict:
    """Demangled name -> SASS of each of K4's kernels (names holding `match`) in
    `library`: the instructions alone, without addresses or encodings, with
    each branch label and each numbered internal subroutine (the slow paths
    of division and the like, numbered across the library) renamed by its
    order of appearance in the kernel, so that one kernel compiled under two
    names, or beside other kernels, reads the same."""
    from omnimamba_tpu_torch.ops import kernel_build

    bin_dir = Path(kernel_build._find_nvcc()).parent
    dump = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    kernels, name = {}, None
    for ln in dump.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            kernels[name] = [] if match in name else None
            continue
        instr = re.match(r"\s*/\*[0-9a-f]+\*/(.*?);", ln)  # an instruction line: its address
        if name and kernels[name] is not None and instr:
            kernels[name].append(" ".join(instr.group(1).split()))
    kernels = {k: v for k, v in kernels.items() if v is not None}
    demangled = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(kernels),
                               check=True, capture_output=True, text=True).stdout.splitlines()
    out = {}
    for (mangled, lines), pretty in zip(kernels.items(), demangled):
        text, names = "\n".join(lines), {}
        numbered = r"\.L_x_\d+|__internal_\d+_"
        for sym in re.findall(numbered, text):
            names.setdefault(sym, f"<{len(names)}>")
        out[pretty or mangled] = re.sub(numbered, lambda m: names[m.group(0)], text)
    return out


def probe(root: Path, out: Path) -> dict:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from omnimamba_tpu_torch.config import LoraConfig, Mamba2LayerConfig
    from omnimamba_tpu_torch.ops import decode_fused
    from omnimamba_tpu_torch.ops.decode_fused import (
        fused_decode_step, prepare_fused_decode)
    from omnimamba_tpu_torch.ops.quant import quantize_decode_params

    assert Path(cs.__file__).resolve().parent == root.resolve(), cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, lcfg, bf = Mamba2LayerConfig(), LoraConfig(), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    layers = cs.fused_layers(gen, 48, cfg, lcfg, bf)
    rec, saved = {"root": str(root)}, {}

    qlayers = quantize_decode_params({"layers": layers})["layers"]

    def inputs(n_layer, B, state=bf):
        return (cs.rand(gen, (B, cfg.d_model), bf), cs.rand(gen, (B, cfg.d_model), torch.float32),
                cs.fused_state(gen, n_layer, B, cfg, bf, state))

    # key, layers, rows, state dtype
    for key, stack, B, state in (
            (f"L1_B{cs.BATCH}", layers[:1], cs.BATCH, bf),
            (f"L48_B{cs.BATCH}", layers, cs.BATCH, bf),
            (f"L1_B{2 * cs.BATCH}", layers[:1], 2 * cs.BATCH, bf),
            ("L48_B16_fp32_state", layers, 16, torch.float32),
            (f"L48_B{cs.BATCH}_int8", qlayers, cs.BATCH, bf),
            ("L1_B16_int8", qlayers[:1], 16, bf),
            (f"L1_B{2 * cs.BATCH}_int8", qlayers[:1], 2 * cs.BATCH, bf)):
        h, residual, cache = inputs(len(stack), B, state)
        plan = prepare_fused_decode(stack, "t2i", cfg, lcfg, B, bf)
        h_out, res_out, _ = fused_decode_step(stack, h, residual, cache, "t2i", cfg, lcfg, 1e-5,
                                              plan=plan)
        torch.cuda.synchronize()
        saved.update({f"{key}_h": h_out, f"{key}_residual": res_out,
                      f"{key}_conv_window": cache.conv_state, f"{key}_ssm_state": cache.ssm_state})
        del cache, plan
    torch.save({k: v.cpu() for k, v in saved.items()}, out)
    del saved
    from omnimamba_tpu_torch.ops import kernel_build

    sass = k4_sass(kernel_build.build_kernels().library)
    Path(f"{out}.sass.json").write_text(json.dumps(sass))
    rec["sass_kernels"] = sorted(sass)

    def timed(stack, B, key, state=bf, alone=()):
        h, _, cache = inputs(len(stack), B, state)
        plan = prepare_fused_decode(stack, "t2i", cfg, lcfg, B, bf)

        def step():
            fused_decode_step(stack, h, None, cache, "t2i", cfg, lcfg, 1e-5, plan=plan)

        def host_ms():  # the host's time to enqueue a step while the device is kept busy
            cs._occupy_device(30.0)
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            return dt / 3 * 1e3

        rec[key] = {"batch": B, "state": str(state), "step_ms": cs.time_ms(step, 10),
                    "host_ms_per_step": statistics.median(host_ms() for _ in range(5)),
                    **profile(step)}
        if alone:  # the same draws on every checkout
            residual, turn = cs.rand(gen, (B, cfg.d_model), torch.float32), [0]
            for name in alone:
                rec[key][f"{name}_alone_ms"] = rec[key][f"{name}_one_launch_ms"] = None
                launch = getattr(decode_fused, f"fused_decode_{name}", None)
                if launch is None:
                    continue
                res = residual if name == "prenorm" else None

                def phase():
                    launch(stack, h, res, cache, "t2i", cfg, lcfg, 1e-5, plan=plan,
                           layer=turn[0] % len(stack))
                    turn[0] += 1

                rec[key][f"{name}_alone_ms"] = cs.time_ms(phase, 2 * len(stack))
                rec[key][f"{name}_one_launch_ms"] = cs.time_alone_ms(phase, 2 * len(stack))
        if "out_proj" in alone:  # an int8 W_out as bf16: twice the weight bytes
            ya = plan.scratch["ya"]
            w_out = [layer["mixer"]["out_proj"]["kernel"] for layer in stack]
            w_out = [w["q"].to(bf) if isinstance(w, dict) else w for w in w_out]

            def product():
                torch.matmul(ya, w_out[turn[0] % len(stack)])
                turn[0] += 1

            rec[key]["out_proj_matmul_ms"] = cs.time_ms(product, 2 * len(stack))
        print(json.dumps({key: rec[key]}), flush=True)

    for B in (16, cs.BATCH, 2 * cs.BATCH):
        timed(layers, B, f"bf16_B{B}", alone=("prenorm", "out_proj"))
    for B in (8, 16):
        timed(layers, B, f"bf16_B{B}_fp32_state", torch.float32)
    del layers
    torch.cuda.empty_cache()
    for B in (16, cs.BATCH, 2 * cs.BATCH):
        timed(qlayers, B, f"int8_B{B}", alone=("in_proj", "out_proj"))
    return rec


def compare(a: Path, b: Path) -> dict:
    ta, tb = torch.load(a), torch.load(b)
    assert ta.keys() == tb.keys(), (sorted(ta), sorted(tb))
    equal = {k: torch.equal(ta[k], tb[k]) for k in ta}
    rec = {"compare": [str(a), str(b)], "bits_equal": equal,
           "max_abs_diff": {k: (ta[k].float() - tb[k].float()).abs().max().item() for k in ta}}
    sa, sb = Path(f"{a}.sass.json"), Path(f"{b}.sass.json")
    if sa.exists() and sb.exists():
        ka, kb = json.loads(sa.read_text()), json.loads(sb.read_text())
        rec["sass_of_a_in_b"] = {n: [m for m, t in kb.items() if t == text] for n, text in ka.items()}
        rec["sass_of_a_not_in_b"] = [n for n, m in rec["sass_of_a_in_b"].items() if not m]
        # of those that B has by the same name: the first instruction that differs
        rec["sass_first_difference"] = {
            n: next(((i, x, y) for i, (x, y) in enumerate(zip(ka[n].splitlines(),
                                                                kb[n].splitlines())) if x != y),
                    "one is a prefix of the other")
            for n in rec["sass_of_a_not_in_b"] if n in kb}
    print(json.dumps(rec), flush=True)
    assert all(equal.values()), rec
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="the checkout to probe")
    ap.add_argument("--out", type=Path, help="where to save the outputs")
    ap.add_argument("--compare", type=Path, nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return 0
    if args.root is None or args.out is None:
        ap.error("--root and --out, or --compare")
    if not torch.cuda.is_available():
        print("k4_probe: needs one CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    rec = probe(args.root, args.out)
    print(json.dumps({"card": card, "seconds": time.time() - t0, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What holds K7's two tensor-core paths back: their products with parts of the
work taken out.

    python3 tools/k7_ablation.py [decode] [prefill]

needs one NVIDIA GPU and nvcc. For each path named (both if none is), it builds
``omnimamba_tpu_torch/csrc/qmatmul.cu`` once for each entry of the path's
``builds``, all builds in parallel, with the path's measurement macro set to
the entry's value, and times each build on the path's shapes with that path
forced:

- ``decode`` (bf16 activations below ``M_TILE`` rows), ``OMT_QMM_PAIR_SKIP``:
  the 1.3B's decode shapes of ``chip_smoke.py`` at 48 rows, the step in_proj
  also at 16 rows and one row; each time the median of three;
- ``prefill`` (the 128-row tiles), ``OMT_QMM_WIDE_SKIP``: the prefill in_proj
  and out_proj at 3,456 rows and the in_proj at 1,024 rows.

Only the build with the value 0 gives correct results; it must equal the
library's bits, which is asserted. Prints the card, one JSON line a shape, then
one JSON line of all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_bf, _f32 = torch.bfloat16, torch.float32
# macro: the path's measurement macro; m_tile: K7's M_TILE that forces the path;
# builds: macro value -> name; shapes: name -> (rows, K, O, (O, K) table, out dtype);
# repeats, iters: a time is the median of `repeats` time_ms calls of `iters` launches
PATHS = {
    "decode": {
        "macro": "OMT_QMM_PAIR_SKIP", "m_tile": 1 << 30, "repeats": 3, "iters": 20,
        "builds": {0: "as shipped", 1: "no activation copies", 2: "no weight copies",
                   3: "no copies", 4: "no widening or products",
                   7: "launch, barriers and stores only", 8: "launch only"},
        "shapes": {
            "step_in_proj": (48, 2048, 8512, False, _bf),
            "step_out_proj": (48, 4096, 2048, False, _bf),
            "project_in_fc1": (48, 2048, 8192, False, _bf),
            "project_in_fc2": (48, 8192, 2048, False, _bf),
            "project_in_fc3": (48, 2048, 2048, False, _bf),
            "image_head": (48, 2048, 16384, True, _f32),
            "step_in_proj_16_rows": (16, 2048, 8512, False, _bf),
            "step_in_proj_one_row": (1, 2048, 8512, False, _bf),
        },
    },
    "prefill": {
        "macro": "OMT_QMM_WIDE_SKIP", "m_tile": 1, "repeats": 1, "iters": 5,
        "builds": {0: "as shipped", 1: "no widening", 2: "no copies",
                   3: "products and ldmatrix only"},
        "shapes": {
            "prefill_in_proj": (3456, 2048, 8512, False, _bf),
            "prefill_out_proj": (3456, 4096, 2048, False, _bf),
            "slot_prefill_in_proj": (1024, 2048, 8512, False, _bf),
        },
    },
}


def build(macro: str, value: int, out_dir: Path, nvcc: str, flags) -> subprocess.Popen:
    lib = out_dir / f"libk7_{macro}_{value}.so"
    cmd = [nvcc, *flags, "-shared", f"-D{macro}={value}", "-o", str(lib),
           str(ROOT / "omnimamba_tpu_torch" / "csrc" / "qmatmul.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", help="decode, prefill (default: both)")
    paths = ap.parse_args().paths or list(PATHS)
    if set(paths) - set(PATHS):
        ap.error(f"paths are {', '.join(PATHS)}")
    if not torch.cuda.is_available():
        print("k7_ablation: needs one CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from omnimamba_tpu_torch.ops import kernel_build as kb
    from omnimamba_tpu_torch.ops.quant import quantize_linear
    from omnimamba_tpu_torch.ops.quant_kernel import qmatmul

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out_dir = kb.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {(p, v): build(PATHS[p]["macro"], v, out_dir, kb._find_nvcc(), kb.NVCC_FLAGS)
             for p in paths for v in PATHS[p]["builds"]}
    kb.load_kernels()
    libs, ptxas = {}, {}
    for (p, v), proc in procs.items():
        macro = PATHS[p]["macro"]
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {macro}={v}:\n{log}")
        ptxas[f"{macro}={v}"] = sorted(
            {ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln})
        lib = ctypes.CDLL(str(out_dir / f"libk7_{macro}_{v}.so"))
        lib.omt_qmatmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.omt_qmatmul.restype = ctypes.c_int
        libs[p, v] = lib

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = {}
    for p in paths:
        spec = PATHS[p]
        for shape, (M, K, O, tr, od) in spec["shapes"].items():
            w = cs.rand(gen, (O, K) if tr else (K, O), _f32, 0.02)
            qe = quantize_linear(w, (1,) if tr else (0,))
            q, sc = qe["q"], qe["scale"]
            x = cs.rand(gen, (M, K), _bf)
            y = torch.empty((M, O), dtype=od, device="cuda")

            def launch(lib):
                err = lib.omt_qmatmul(x.data_ptr(), q.data_ptr(), sc.data_ptr(), y.data_ptr(), M, K,
                                      O, int(tr), kb.BF16, kb.dtype_code(od), spec["m_tile"],
                                      torch.cuda.current_stream().cuda_stream)
                kb.check_launch(err, "qmatmul ablation")

            with cs._m_tile(spec["m_tile"]):
                want = qmatmul(x, q, sc, tr, od)
            launch(libs[p, 0])
            torch.cuda.synchronize()
            assert torch.equal(y, want), f"the build with {spec['macro']}=0 differs at {shape}"
            bytes_ms = cs.nbytes(x, q, sc, y) / cs.HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * M * K * O / cs.PEAK_OPS[_bf] * 1e3
            rec = {"path": p, "shape": (M, K, O), "layout": "(O, K)" if tr else "(K, O)",
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            for v, name in spec["builds"].items():
                rec[name] = statistics.median(cs.time_ms(lambda: launch(libs[p, v]), spec["iters"])
                                              for _ in range(spec["repeats"]))
            rows[shape] = rec
            print(json.dumps({shape: rec}), flush=True)
    print(json.dumps({"card": card, "k7_ablation": rows, "ptxas": ptxas,
                      "builds": {p: {PATHS[p]["macro"]: PATHS[p]["builds"]} for p in paths}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

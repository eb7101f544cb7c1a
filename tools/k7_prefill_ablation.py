"""What holds K7's 128-row path back: its prefill products with parts of a k
step taken out.

    python3 tools/k7_prefill_ablation.py

needs one NVIDIA GPU and nvcc. It builds ``omnimamba_tpu_torch/csrc/qmatmul.cu``
four times, with ``OMT_QMM_WIDE_SKIP`` 0 (the kernel as shipped), 1 (no
widening of the int8 tile), 2 (no copies into the ring) and 3 (neither: the
ldmatrix loads and mma.sync products alone), and times each on the 1.3B's
prefill in_proj and out_proj at 3,456 rows and the in_proj at 1,024 rows (bf16,
(K, O) layout), with the 128-row tiles forced. Only the build with 0 gives a
correct result; it must equal the library's bits. Prints the card, then one
JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SKIPS = {0: "as shipped", 1: "no widening", 2: "no copies", 3: "products and ldmatrix only"}
SHAPES = {"prefill_in_proj": (3456, 2048, 8512), "prefill_out_proj": (3456, 4096, 2048),
          "slot_prefill_in_proj": (1024, 2048, 8512)}


def build(skip: int, out_dir: Path, nvcc: str, flags) -> subprocess.Popen:
    lib = out_dir / f"libk7_skip{skip}.so"
    cmd = [nvcc, *flags, "-shared", f"-DOMT_QMM_WIDE_SKIP={skip}", "-o", str(lib),
           str(ROOT / "omnimamba_tpu_torch" / "csrc" / "qmatmul.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_prefill_ablation: needs one CUDA device", file=sys.stderr)
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
    procs = {s: build(s, out_dir, kb._find_nvcc(), kb.NVCC_FLAGS) for s in SKIPS}
    kb.load_kernels()
    libs, ptxas = {}, {}
    for s, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for OMT_QMM_WIDE_SKIP={s}:\n{log}")
        ptxas[s] = sorted({ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln})
        lib = ctypes.CDLL(str(out_dir / f"libk7_skip{s}.so"))
        lib.omt_qmatmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.omt_qmatmul.restype = ctypes.c_int
        libs[s] = lib

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows = {}
    for name, (M, K, O) in SHAPES.items():
        qe = quantize_linear(cs.rand(gen, (K, O), torch.float32, 0.02), (0,))
        q, sc = qe["q"], qe["scale"]
        x = cs.rand(gen, (M, K), torch.bfloat16)
        y = torch.empty((M, O), dtype=torch.bfloat16, device="cuda")

        def launch(lib):
            err = lib.omt_qmatmul(x.data_ptr(), q.data_ptr(), sc.data_ptr(), y.data_ptr(), M, K, O, 0,
                                  kb.BF16, kb.BF16, 1, torch.cuda.current_stream().cuda_stream)
            kb.check_launch(err, "qmatmul ablation")

        with cs._m_tile(1):
            want = qmatmul(x, q, sc)
        launch(libs[0])
        torch.cuda.synchronize()
        assert torch.equal(y, want), "the build with OMT_QMM_WIDE_SKIP=0 differs from the library"
        rec = {"shape": (M, K, O), "bound_ms": 2 * M * K * O / cs.PEAK_OPS[torch.bfloat16] * 1e3}
        for s in SKIPS:
            rec[f"skip{s}_ms"] = cs.time_ms(lambda: launch(libs[s]), 5)
        rows[name] = rec
    print(json.dumps({"card": card, "k7_prefill_ablation": rows, "builds": SKIPS, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K3a and K3b (the two forward RMS norms of a Mamba-2 block) of one checkout
of the port, on the card: the bits of their outputs on fixed inputs, their
device time, the host's time a call and the SASS of every kernel of the
port's library, so that two checkouts (a change and its parent) can be held
against each other in one call.

    python3 tools/norm_probe.py --root DIR --out FILE
    python3 tools/norm_probe.py --compare FILE_A FILE_B
    python3 tools/norm_probe.py --sass-builds N DIR [DIR ...]

needs one NVIDIA GPU and nvcc. The first form imports the port and
`chip_smoke.py` from DIR (a checkout, for example `git archive` of a parent
unpacked into a git-ignored directory) and, on bf16 rows with bf16 weights
(K3a d = 2048 with an fp32 residual, K3b d = 4096 with z a column slice of a
wider matrix, as the layer loop passes them):

- saves the SHA-256 of the bytes of out (and K3a's y) at rows 1, 16, 48, 96,
  256 and 3,456 to FILE (JSON);
- times each at those rows, each launch on the next of 48 inputs (4 at
  3,456 rows and at the training shape, 90 x 328 rows), back to back
  (`chip_smoke.time_ms`) and one launch alone (`chip_smoke.time_alone_ms`);
- times the host's share of one call at 48 rows (`chip_smoke.host_us`, the
  median of five means of 200 calls), beside the parts such a call is made
  of, each timed the same way on the same tensors: the ctypes call of the
  library's entry with its arguments ready, the `torch.empty` of the outputs
  (and as `torch.empty_like`), `kernel_build.as_rows` of the inputs,
  `norms_kernel._vectorizable`, `kernel_build.current_stream`, the launch
  counter's increment;
- writes the SASS of every kernel in the checkout's library
  (`k4_probe.k4_sass`) to FILE.sass.json, by name.

Prints the card, then one JSON line. The second form asserts that every saved
output of A equals B's bit for bit and names the kernels of A whose SASS no
kernel of B has (`k4_probe.py --compare` prints where such SASS first differs).

The third form needs nvcc alone: it compiles `csrc/norms.cu` of each checkout
DIR N times, all compilers started together with the library's flags, and
names, for each kernel of the first DIR, the distinct SASS texts that the
builds gave it and which builds gave each. A kernel whose one source gives
more than one text differs between builds of an unchanged source, and a
difference in it between two checkouts says nothing of either's source.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

ROWS = (1, 16, 48, 96, 256)


def probe(root: Path, out: Path) -> dict:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from k4_probe import k4_sass
    from omnimamba_tpu_torch.ops import kernel_build as kb
    from omnimamba_tpu_torch.ops import norms_kernel as nk

    assert Path(cs.__file__).resolve().parent == root.resolve(), cs.__file__
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    fns = {"add": nk.fused_add_rms_norm, "gated": nk.fused_gated_rms_norm}

    def inputs(kind, lead, d):
        a = cs.rand(gen, (*lead, d), bf)
        b = cs.rand(gen, (*lead, d), f32) if kind == "add" else cs.sliced(
            gen, lead, (d, 4096 + 256 + 64), bf)[0]
        return a, b, (1.0 + 0.1 * cs.rand(gen, (d,), f32)).to(bf)

    rec, saved = {"root": str(root), "ms": {}, "ms_alone": {}, "host_us": {}}, {}
    for kind, d in (("add", 2048), ("gated", 4096)):
        fn = fns[kind]
        rec["ms"][kind], rec["ms_alone"][kind] = {}, {}
        for rows in (*ROWS, cs.BATCH * cs.PROMPT, "train"):
            lead = (cs.TRAIN_BATCH, cs.TRAIN_LEN) if rows == "train" else (rows,)
            n_in = 4 if rows in ("train", cs.BATCH * cs.PROMPT) else cs.STATE_LAYERS
            layers = [inputs(kind, lead, d) for _ in range(n_in)]
            if rows != "train":
                outs = fn(*layers[0], 1e-5)
                for i, t in enumerate(outs if isinstance(outs, tuple) else (outs,)):
                    saved[f"{kind}_{rows}_{i}"] = hashlib.sha256(
                        t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            turn = iter(range(1 << 30))

            def call():
                return fn(*layers[next(turn) % n_in], 1e-5)

            n = 2 * n_in
            rec["ms"][kind][rows] = cs.time_ms(call, n)
            rec["ms_alone"][kind][rows] = cs.time_alone_ms(call, n)
            del layers
    out.write_text(json.dumps(saved))

    # the host's share of one call at 48 rows, and of its parts
    lib = kb.load_kernels()
    for kind, d in (("add", 2048), ("gated", 4096)):
        fn, (a, b, w) = fns[kind], inputs(kind, (cs.BATCH,), d)
        o = torch.empty(a.shape, dtype=a.dtype, device=a.device)
        y = torch.empty(a.shape, dtype=f32, device=a.device)
        stream = kb.current_stream(a.device)
        b_rs = kb.as_rows(b, 1)[1]
        if kind == "add":
            args = (a.data_ptr(), b.data_ptr(), w.data_ptr(), o.data_ptr(), y.data_ptr(), d, d,
                    cs.BATCH, d, 1e-5, kb.BF16, kb.BF16, 1, stream)
            entry = lib.omt_add_rms_norm
        else:
            args = (a.data_ptr(), b.data_ptr(), w.data_ptr(), o.data_ptr(), d, b_rs, cs.BATCH, d,
                    1e-5, kb.BF16, kb.BF16, 1, stream)
            entry = lib.omt_gated_rms_norm

        def empties():
            torch.empty(a.shape, dtype=a.dtype, device=a.device)
            if kind == "add":
                torch.empty(a.shape, dtype=f32, device=a.device)

        def empties_like():
            torch.empty_like(a, memory_format=torch.contiguous_format)
            if kind == "add":
                torch.empty_like(a, dtype=f32, memory_format=torch.contiguous_format)

        def counter():
            fn.launches += 1

        parts = {"call": lambda: fn(a, b, w, 1e-5), "ctypes_call": lambda: entry(*args),
                 "torch_empty": empties, "torch_empty_like": empties_like,
                 "as_rows": lambda: (kb.as_rows(a, 1), kb.as_rows(b, 1)),
                 "vectorizable": lambda: nk._vectorizable(d, (d, b_rs), (a, b, w, o)),
                 "current_stream": lambda: kb.current_stream(a.device), "launch_counter": counter}
        rec["host_us"][kind] = {k: statistics.median(cs.host_us(f) for _ in range(5))
                                for k, f in parts.items()}
        torch.cuda.synchronize()

    sass = k4_sass(kb.build_kernels().library, "")
    Path(f"{out}.sass.json").write_text(json.dumps(sass))
    rec["sass_kernels"] = len(sass)
    return rec


def compare(a: Path, b: Path) -> dict:
    ta, tb = json.loads(a.read_text()), json.loads(b.read_text())
    assert ta.keys() == tb.keys(), (sorted(ta), sorted(tb))
    equal = {k: ta[k] == tb[k] for k in ta}
    rec = {"compare": [str(a), str(b)], "bits_equal": equal}
    sa, sb = Path(f"{a}.sass.json"), Path(f"{b}.sass.json")
    if sa.exists() and sb.exists():
        ka, kb = json.loads(sa.read_text()), json.loads(sb.read_text())
        texts = set(kb.values())
        rec["kernels_of_a"] = len(ka)
        rec["sass_of_a_not_in_b"] = sorted(n for n, text in ka.items() if text not in texts)
    print(json.dumps(rec), flush=True)
    assert all(equal.values()), rec
    return rec


def sass_builds(n: int, roots: list) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import tempfile

    from k4_probe import k4_sass
    from omnimamba_tpu_torch.ops import kernel_build as kb

    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for r, root in enumerate(roots):
            for b in range(n):
                obj = Path(tmp) / f"{r}_{b}.o"
                src = Path(root) / "omnimamba_tpu_torch" / "csrc" / "norms.cu"
                cmd = [kb._find_nvcc(), *kb.NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                procs[f"{root}#{b}"] = (obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        sass = {}
        for build, (obj, proc) in procs.items():
            out, _ = proc.communicate()
            assert proc.returncode == 0, (build, out[-3000:])
            sass[build] = k4_sass(obj, "")
    first = [b for b in sass if b.startswith(f"{roots[0]}#")]
    forms = {}
    for kernel in sass[first[0]]:
        texts = {}
        for build, kernels in sass.items():
            if kernel in kernels:
                texts.setdefault(kernels[kernel], []).append(build)
        forms[kernel] = list(texts.values())
    return {"builds": list(sass), "kernels": len(forms),
            "kernels_with_more_than_one_sass": {k: v for k, v in forms.items() if len(v) > 1}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="the checkout to probe")
    ap.add_argument("--out", type=Path, help="where to save the outputs")
    ap.add_argument("--compare", type=Path, nargs=2, metavar=("A", "B"))
    ap.add_argument("--sass-builds", nargs="+", metavar=("N", "DIR"))
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return 0
    if args.sass_builds:
        n, *roots = args.sass_builds
        if not roots:
            ap.error("--sass-builds N DIR [DIR ...]")
        print(json.dumps(sass_builds(int(n), roots)), flush=True)
        return 0
    if args.root is None or args.out is None:
        ap.error("--root and --out, or --compare")
    if not torch.cuda.is_available():
        print("norm_probe: needs one CUDA device", file=sys.stderr)
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

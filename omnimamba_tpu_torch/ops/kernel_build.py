"""Builds the CUDA sources under ``csrc/`` into one shared library and loads
it with ``ctypes``.

Nothing here runs when the module is imported. The first kernel launch (or an
explicit ``build_kernels()``) compiles every ``*.cu`` with ``nvcc`` for
``sm_90a``, one compiler process per source, all started together, links the
objects into ``build/libomnimamba_kernels_<hash>.so`` and loads that. The
file name carries a hash of the sources and the flags, so an edit rebuilds
and an unchanged tree reuses the library. A failed build raises; there is
no other path for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

F32, BF16, I8 = 0, 1, 2  # element type codes of csrc/common.cuh
# the headers the sources include: an edit of one rebuilds the library
HEADERS = ("common.cuh", "ssd_step_row.cuh", "tensor_core.cuh", "tma.cuh")


class BuildInfo(NamedTuple):
    library: Path
    built: bool  # False when an up-to-date library was reused
    seconds: float
    commands: List[str]
    log: str  # the compiler's output (registers, shared memory, spills)


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, under CUDA_HOME and /usr/local/cuda): "
        "the port's CUDA kernels are compiled on the machine that has the card"
    )


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + [CSRC_DIR / name for name in HEADERS]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> BuildInfo:
    """Compile and link the kernel library unless an up-to-date one exists."""
    t0 = time.time()
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib = BUILD_DIR / f"libomnimamba_kernels_{_source_hash()}.so"
    if lib.exists():
        return BuildInfo(lib, False, time.time() - t0, [], "")

    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    commands, logs = [], []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            commands.append(" ".join(cmd))
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objects, failed = [], []
        for cmd, obj, proc in procs:  # wait for every compiler before raising
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
            objects.append(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, lib.name)
        link = [nvcc, "-shared", "-o", tmp_lib, *objects]
        commands.append(" ".join(link))
        done = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(done.stdout)
        if done.returncode != 0:
            raise RuntimeError(f"link failed: {' '.join(link)}\n{done.stdout}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent process sees all or nothing
    return BuildInfo(lib, True, time.time() - t0, commands, "\n".join(logs))


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Every exported function
    returns the ``cudaError_t`` of its launch as an int."""
    lib = ctypes.CDLL(str(build_kernels().library))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    # pointers and the stream are c_void_p: an unannotated Python int would be
    # passed as a 32-bit int and the address cut
    lib.omt_add_rms_norm.argtypes = (
        [ptr] * 5 + [i64, i64, i64, i32, f32, i32, i32, i32, ptr])
    lib.omt_gated_rms_norm.argtypes = (
        [ptr] * 4 + [i64, i64, i64, i32, f32, i32, i32, i32, ptr])
    lib.omt_add_rms_norm_bwd.argtypes = (
        [ptr] * 8 + [i64, i64, i64, i32, f32, i32, i32, i32, i32, ptr])
    lib.omt_gated_rms_norm_bwd.argtypes = (
        [ptr] * 8 + [i64, i64, i64, i64, i32, f32, i32, i32, i32, i32, ptr])
    lib.omt_ssd_step.argtypes = [ptr] * 8 + [i64] * 3 + [i32] * 7 + [ptr]
    lib.omt_ssd_scan.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 7 + [ptr]
    lib.omt_ssd_scan_bwd.argtypes = [ptr] * 17 + [i64] * 4 + [i32] * 8 + [ptr]
    lib.omt_ssd_step_q8.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 6 + [ptr]
    lib.omt_fused_decode_step.argtypes = (
        [ptr] + [i32] * 10 + [f32] * 3 + [ptr] * 14 + [i32] * 5 + [ptr, ptr, i32, i32, ptr])
    lib.omt_fused_decode_in_maps.argtypes = [ptr] + [i32] * 5 + [ptr] * 2
    lib.omt_qmatmul.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.omt_qmatmul_pair_plan.argtypes = [i32] * 3 + [ptr]
    lib.omt_gated_rms_norm_bwd_blocks_per_sm.argtypes = [i64] * 3 + [i32] * 4
    for fn in (lib.omt_ssd_scan_bf16_smem_bytes, lib.omt_ssd_scan_bwd_bf16_smem_bytes):
        fn.argtypes = [i32, i32]
        fn.restype = i64
    for fn in (lib.omt_add_rms_norm, lib.omt_gated_rms_norm, lib.omt_add_rms_norm_bwd,
               lib.omt_gated_rms_norm_bwd, lib.omt_ssd_step, lib.omt_ssd_step_q8, lib.omt_ssd_scan,
               lib.omt_ssd_scan_bwd, lib.omt_fused_decode_step, lib.omt_fused_decode_in_maps,
               lib.omt_qmatmul, lib.omt_qmatmul_pair_plan,
               lib.omt_gated_rms_norm_bwd_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


def dtype_code(dtype) -> int:
    """Element type code for a float32 or bfloat16 tensor; raises otherwise."""
    if dtype == torch.float32:
        return F32
    if dtype == torch.bfloat16:
        return BF16
    raise TypeError(f"the kernels take float32 or bfloat16, not {dtype}")


def as_rows(t: torch.Tensor, inner: int) -> Tuple[torch.Tensor, int]:
    """``t`` as equally spaced rows for a kernel that takes a row stride:
    returns (tensor, elements from one row to the next). A row is the last
    ``inner`` dimensions and must be dense; the leading dimensions must step
    evenly from row to row. A column slice of a wider matrix (the mixer's
    x | B | C and z) qualifies and goes in as it is; any other layout is
    copied to a contiguous tensor first."""
    if t.is_contiguous():
        return t, math.prod(t.shape[-inner:])
    if t.dim() == 2 and inner == 1 and t.stride(1) == 1:  # a column slice of a matrix
        return t, t.stride(0)
    row = 1
    for size, stride in zip(reversed(t.shape[-inner:]), reversed(t.stride()[-inner:])):
        if size != 1 and stride != row:
            return t.contiguous(), math.prod(t.shape[-inner:])
        row *= size
    lead = [(size, stride) for size, stride in zip(t.shape[:-inner], t.stride()[:-inner])
            if size != 1]
    if not lead:
        return t, row
    for (_, outer), (size, stride) in zip(lead[:-1], lead[1:]):
        if outer != size * stride:
            return t.contiguous(), row
    return t, lead[-1][1]


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")


def current_stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw ``cudaStream_t``. A launch
    goes to the current device, so a tensor on another card is refused."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(
            f"tensor lies on {device} but the current CUDA device is "
            f"cuda:{current}; use torch.cuda.device(...)"
        )
    return torch._C._cuda_getCurrentRawStream(current)  # without building a torch.cuda.Stream

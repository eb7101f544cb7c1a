"""Which collectives a backend takes on CUDA tensors, and at what rate.

    python3 tools/collective_probe.py

On a machine with one card: two gloo ranks on ``cuda:0`` and one nccl rank
(world of one) each run ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_gather``, ``broadcast`` and ``barrier`` on
fp32 and bf16 tensors, check the values, build a ``DeviceMesh`` with the
axes dp, fsdp, tp and time a 64-MB ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` (CUDA events, after a warm-up). One JSON line a
backend; a collective the backend refuses is reported with its error, which
is what this probe is for. The port's collectives are in
``omnimamba_tpu_torch/parallel/``.

A last line times what fsdp's cut of a 1.3B out_proj kernel (4096, 2048)
bf16 along dimension 1 (JAX's axis) costs beyond a cut along dimension 0:
``assemble`` after a gather and ``split_slices`` before a reduce-scatter,
over 2 ranks, each way (no collective: the copies alone).
"""

from __future__ import annotations

import json
import subprocess
import sys
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _try(rec, name, fn):
    try:
        rec[name] = fn()
    except Exception as e:  # noqa: BLE001 - the refusal is the finding
        rec[name] = f"error: {type(e).__name__}: {str(e).splitlines()[0][:300]}"


def probe(rank, world, dev):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.cuda.set_device(dev)
    rec = {"backend": dist.get_backend(), "world": world, "torch": torch.__version__}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]

        def all_reduce():
            t = torch.full((1024,), float(rank + 1), device=dev, dtype=dtype)
            dist.all_reduce(t)
            return bool((t == sum(range(1, world + 1))).all())

        def gather_into():
            t = torch.full((256,), float(rank), device=dev, dtype=dtype)
            out = torch.empty(256 * world, device=dev, dtype=dtype)
            dist.all_gather_into_tensor(out, t)
            want = torch.arange(world, device=dev, dtype=dtype).repeat_interleave(256)
            return bool(torch.equal(out, want))

        def reduce_scatter():
            t = torch.arange(world * 256, device=dev, dtype=torch.float32).to(dtype)
            out = torch.empty(256, device=dev, dtype=dtype)
            dist.reduce_scatter_tensor(out, t)
            want = (world * torch.arange(rank * 256, (rank + 1) * 256, device=dev,
                                         dtype=torch.float32)).to(dtype)
            return bool(torch.equal(out, want))

        def gather_list():
            t = torch.full((256,), float(rank), device=dev, dtype=dtype)
            outs = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(outs, t)
            return all(bool((o == r).all()) for r, o in enumerate(outs))

        def broadcast():
            t = torch.full((256,), float(rank + 7), device=dev, dtype=dtype)
            dist.broadcast(t, src=0)
            return bool((t == 7).all())

        for name, fn in (("all_reduce", all_reduce), ("all_gather_into_tensor", gather_into),
                         ("reduce_scatter_tensor", reduce_scatter), ("all_gather", gather_list),
                         ("broadcast", broadcast)):
            _try(rec, f"{name}_{tag}", fn)
    _try(rec, "barrier", lambda: dist.barrier() or True)

    def mesh():
        m = init_device_mesh("cuda", (1, world, 1), mesh_dim_names=("dp", "fsdp", "tp"))
        t = torch.ones(8, device=dev)
        dist.all_reduce(t, group=m.get_group("fsdp"))
        return {"mesh": str(m), "fsdp_sum_ok": bool((t == world).all())}

    _try(rec, "device_mesh", mesh)

    def rate(op):
        n = 32 * 2**20  # 64 MB of bf16 gathered (or scattered) a call
        src = torch.ones(n // world if op == "gather" else n, device=dev, dtype=torch.bfloat16)
        dst = torch.empty(n if op == "gather" else n // world, device=dev, dtype=torch.bfloat16)
        call = (lambda: dist.all_gather_into_tensor(dst, src)) if op == "gather" else (
            lambda: dist.reduce_scatter_tensor(dst, src))
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        return {"ms_per_64MB": ms, "GB_per_s": 2 * n / ms / 1e6}

    _try(rec, "all_gather_into_tensor_rate", lambda: rate("gather"))
    _try(rec, "reduce_scatter_tensor_rate", lambda: rate("scatter"))
    return rec


def gloo_rank(rank, world):
    return probe(rank, world, 0)


def nccl_rank(rank, world):
    return probe(rank, world, rank)


def slice_copy_cost(dev="cuda", shape=(4096, 2048), n=2, reps=50):
    """ms a call of ``assemble`` and ``split_slices`` for a leaf of ``shape``
    cut over ``n`` ranks along dimension 0 and along dimension 1."""
    from omnimamba_tpu_torch.parallel.sharding import Shard, assemble, split_slices

    full = torch.randn(shape, device=dev).to(torch.bfloat16)
    out = {"shape": list(shape), "ranks": n, "dtype": "bfloat16"}
    for dim in (0, 1):
        spec = Shard(dim, n, 0, tuple(shape), None)
        stacked = split_slices(full, spec)
        assert torch.equal(assemble(stacked, spec), full)
        for name, call in (("assemble", lambda: assemble(stacked, spec)),
                           ("split_slices", lambda: split_slices(full, spec))):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            out[f"{name}_dim{dim}_ms"] = start.elapsed_time(end) / reps
    return out


def main() -> int:
    from omnimamba_tpu_torch.parallel.launch import run_ranks

    if not torch.cuda.is_available():
        print("collective_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for backend, fn, world in (("gloo", gloo_rank, 2), ("nccl", nccl_rank, 1)):
        recs = run_ranks(fn, world, backend=backend, timeout=300)
        print(json.dumps({"collective_probe": backend, "ranks": recs}), flush=True)
    print(json.dumps({"slice_copy_cost": slice_copy_cost()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The host side of the port's training on the CPU: the metric sinks, the
rank-0 logger, the timers and the trace, the native COCO reader (built here
with g++) and the pretokenizing command line, each against the JAX package
where it has a counterpart.
"""

import json
import logging
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnimamba_tpu import config as jcfg
from omnimamba_tpu.data import coco as jcoco
from omnimamba_tpu.data import native as jnative
from omnimamba_tpu.models import vq as jvq
from omnimamba_tpu.utils import convert as jconvert
from omnimamba_tpu_torch import config as tcfg
from omnimamba_tpu_torch.data import coco as tcoco
from omnimamba_tpu_torch.data import native as tnative
from omnimamba_tpu_torch.ops import kernel_build
from omnimamba_tpu_torch.scripts import pretokenize_coco as tpretok
from omnimamba_tpu_torch.train import trainer as ttrainer
from omnimamba_tpu_torch.utils import logging as tlogging
from omnimamba_tpu_torch.utils import profiling
from tests.test_convert_checkpoint import reference_style_vq_state_dict
from tests.test_torch_stage2 import _Prompting

_VQ = dict(codebook_size=32, codebook_embed_dim=8, ch=16, num_res_blocks=1,
           encoder_ch_mult=(1, 2), decoder_ch_mult=(1, 2), z_channels=16)


# ---------------------------------------------------------------------------
# metric sinks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _tensorboard_without_tensorflow():
    """``torch.utils.tensorboard`` imports TensorFlow where it is installed
    (most of these tests' time); tensorboard's own stub, which
    ``tensorboard.compat`` takes when ``tensorboard.compat.notf`` exists,
    writes the same event files."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboard.compat.notf", types.ModuleType("notf"))
        yield


class _Rows:
    def __init__(self):
        self.rows, self.closed = [], False

    def log(self, step, metrics):
        self.rows.append((step, dict(metrics)))

    def close(self):
        self.closed = True


def test_tensorboard_writes_an_event_file(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    w = ttrainer.TensorBoardWriter(str(tmp_path / "tb"))
    w.log(1, {"loss": 2.5, "grad_norm": torch.tensor(0.75), "note": "not a scalar"})
    w.log(2, {"loss": 2.0})
    w.close()
    (event,) = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    acc = EventAccumulator(str(event))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(1, 2.5), (2, 2.0)]
    assert [e.value for e in acc.Scalars("grad_norm")] == [0.75]
    assert "note" not in acc.Tags()["scalars"]


@pytest.mark.parametrize("sink,module", [("TensorBoardWriter", "torch.utils.tensorboard"),
                                         ("WandbWriter", "wandb")])
def test_a_sink_without_its_package_warns_and_drops(sink, module, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, module, None)  # the import raises ImportError
    args = (str(tmp_path / "tb"),) if sink == "TensorBoardWriter" else ()
    with pytest.warns(RuntimeWarning, match="unavailable"):
        w = getattr(ttrainer, sink)(*args)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        w.log(1, {"loss": 1.0})
        w.close()
    assert not (tmp_path / "tb").exists()


def test_multiwriter_fans_out():
    a, b = _Rows(), _Rows()
    w = ttrainer.MultiWriter(a, None, b)
    w.log(3, {"loss": 1.5})
    w.log(4, {"loss": 1.25})
    w.close()
    assert a.rows == b.rows == [(3, {"loss": 1.5}), (4, {"loss": 1.25})]
    assert a.closed and b.closed and len(w.writers) == 2


# ---------------------------------------------------------------------------
# logging and profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", ["0", "1"])
def test_overwatch_speaks_on_rank_zero_only(rank, monkeypatch, caplog):
    monkeypatch.setenv("RANK", rank)
    monkeypatch.setenv("WORLD_SIZE", "2")
    ow = tlogging.initialize_overwatch(f"omt.test.rank{rank}")
    assert ow.rank() == int(rank) and ow.world_size() == 2 and ow.is_rank_zero() == (rank == "0")
    with caplog.at_level(logging.DEBUG, logger=f"omt.test.rank{rank}"):
        ow.logger.logger.setLevel(logging.INFO if rank == "0" else logging.ERROR)
        ow.info("hello", ctx_level=1)
        ow.error("broken")
    messages = [r.getMessage() for r in caplog.records]
    assert ("[=>] hello" in messages) == (rank == "0")
    assert "[*] broken" in messages


def test_overwatch_takes_the_rank_of_an_initialised_group(tmp_path):
    """With a process group (gloo, one rank) the rank and the world size are
    the group's, not RANK / WORLD_SIZE's. In a child process: the test
    workers' own process keeps no process group."""
    code = (
        "import logging, sys\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parent.parent)!r})\n"
        "import torch.distributed as dist\n"
        "from omnimamba_tpu_torch.utils.logging import Overwatch\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path / 'store'}', rank=0,"
        " world_size=1)\n"
        "ow = Overwatch('omt.test.dist')\n"
        "print(ow.rank(), ow.world_size(), ow.logger.logger.level == logging.INFO)\n"
        "dist.destroy_process_group()\n"
        "print(Overwatch.rank(), Overwatch.world_size())\n"
    )
    env = {**os.environ, "RANK": "3", "WORLD_SIZE": "4"}
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.split() == ["0", "1", "True", "3", "4"]


def test_timer_device_time_and_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    lines = []
    with profiling.Timer("mm", log_fn=lines.append, device="cpu") as t:
        for _ in range(10):
            x @ x
    assert t.elapsed > 0 and lines and lines[0].startswith("mm: ") and lines[0].endswith(" ms")
    assert profiling.device_time(torch.matmul, x, x, iters=2) > 0
    assert profiling.bench_compiled(torch.matmul, x, x, loops=3) > 0
    with profiling.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    (trace,) = list((tmp_path / "trace").glob("*.pt.trace.json"))
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# the native COCO reader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def coco_jsonl(tmp_path_factory):
    path = tmp_path_factory.mktemp("coco") / "coco.jsonl"
    rng = np.random.default_rng(3)
    with open(path, "w") as f:
        for i in range(13):
            f.write(json.dumps({"captions": [f"a photo {i} of {'cat dog bird'.split()[i % 3]}"],
                                "tokens": rng.integers(0, 16384, 16).tolist()}) + "\n")
    return str(path)


def test_native_builds_from_the_ports_source(coco_jsonl):
    lib = kernel_build.build_host_library("omnidata")
    assert lib.parent == kernel_build.BUILD_DIR and lib.name.startswith("libomnidata_")
    reader = tnative.NativeCocoReader(coco_jsonl)
    assert len(reader) == 13
    assert reader._lib._name == str(lib)
    reader.close()


def test_native_rows_equal_the_python_dataset_and_jax(coco_jsonl):
    uni = _Prompting()
    port = tnative.NativeCocoDataset(coco_jsonl, uni, seed=5, num_tokens=16)
    idx = np.array([0, 12, 5, 7, 3])
    got = port.read_batch(idx, epoch=1)
    assert got["inputs"].dtype == np.int64 and got["caption_ids"].shape == (5, 73)
    # the Python dataset's items, matched by their image ids (each row has one caption)
    py = tcoco.MSCOCOFeatureDataset(coco_jsonl, uni)
    items = {tuple(tokens): block for tokens, block in (py[i] for i in range(len(py)))}
    assert len(items) == 13
    for tokens, block in zip(got["inputs"], got["caption_ids"]):
        np.testing.assert_array_equal(block, items[tuple(tokens)])
    # JAX's native dataset and loader, batch for batch
    assert jnative.native_available()
    want = jnative.NativeCocoDataset(coco_jsonl, uni, seed=5, num_tokens=16).read_batch(
        idx, epoch=1)
    for k in ("inputs", "caption_ids"):
        np.testing.assert_array_equal(got[k], want[k])
    tl = tnative.NativeCocoLoader(port, 4, seed=2)
    jl = jnative.NativeCocoLoader(jnative.NativeCocoDataset(coco_jsonl, uni, seed=5,
                                                            num_tokens=16), 4, seed=2)
    assert len(tl) == len(jl) == 3
    for _ in range(2):  # two epochs: a new permutation and caption seed each
        for a, b in zip(tl, jl, strict=True):
            for k in ("inputs", "caption_ids"):
                np.testing.assert_array_equal(a[k], b[k])


def test_native_build_failure_raises_with_the_compilers_error(tmp_path, monkeypatch):
    (tmp_path / "omnidata.cpp").write_text("int od_open( {\n")
    monkeypatch.setattr(kernel_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        tnative.NativeCocoReader(str(tmp_path / "any.jsonl"))


# ---------------------------------------------------------------------------
# the pretokenizing command line
# ---------------------------------------------------------------------------


def _write_coco(root, shapes, suffix, seed=4):
    """Images of ``shapes`` (PNG through PIL, or .npy pixels) and a captions
    annotation file with one or two captions an image."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(shapes):
        px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        name = f"img{i}{suffix}"
        if suffix == ".npy":
            np.save(root / name, px)
        else:
            Image.fromarray(px).save(root / name)
        images.append({"id": 10 + i, "file_name": name})
        anns += [{"image_id": 10 + i, "caption": f"caption {i} {j}"} for j in range(1 + i % 2)]
    ann = root / "captions.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(root), str(ann)


@pytest.fixture(scope="module")
def coco_images(tmp_path_factory):
    return _write_coco(tmp_path_factory.mktemp("images"),
                       [(40, 52), (48, 36), (32, 32), (64, 40), (37, 33)], ".png")


def _jax_rows(root, ann, jp, jvcfg, size):
    """The JSONL lines JAX's ``scripts/pretokenize_coco.py`` writes: its
    dataset, its encoder, its row format."""
    ds = jcoco.MSCOCODatabase(root, ann, size=size)
    imgs, caps = zip(*(ds[i] for i in range(len(ds))))
    tokens = np.asarray(jvq.vq_encode(jax.tree.map(jnp.asarray, jp), jnp.asarray(np.stack(imgs)),
                                      jvcfg).indices)
    return [json.dumps({"captions": c, "tokens": t.reshape(-1).tolist()}) + "\n"
            for t, c in zip(tokens, caps)]


@pytest.mark.parametrize("ckpt", [".pt", ".npz"])
def test_pretokenize_rows_equal_jax(ckpt, coco_images, tmp_path):
    root, ann = coco_images
    jvcfg, tvcfg = jcfg.VQConfig(**_VQ), tcfg.VQConfig(**_VQ)
    sd = reference_style_vq_state_dict(jvcfg, np.random.default_rng(5))
    jp = jconvert.convert_vq(sd, jvcfg)
    path = tmp_path / f"vq{ckpt}"
    if ckpt == ".pt":
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    else:
        flat = jax.tree_util.tree_flatten_with_path(jp)[0]
        np.savez(path, **{"/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in k):
                          np.asarray(v) for k, v in flat})
    out = tmp_path / "rows.jsonl"
    n = tpretok.main(["--image-root", root, "--ann", ann, "--vq-ckpt", str(path), "--out",
                      str(out), "--size", "32", "--batch", "2", "--device", "cpu"], vq_cfg=tvcfg)
    lines = out.read_text().splitlines(keepends=True)
    assert n == len(lines) == 5
    assert lines == _jax_rows(root, ann, jp, jvcfg, 32)
    rows = [json.loads(line) for line in lines]
    # two levels: the encoder halves the side once, 16 x 16 codes an image
    assert all(set(r) == {"captions", "tokens"} and len(r["tokens"]) == 256 for r in rows)
    # the native reader reads what the command line wrote
    tokens, caps = tnative.NativeCocoReader(str(out)).read_batch(np.arange(5), num_tokens=256)
    np.testing.assert_array_equal(tokens, [r["tokens"] for r in rows])
    assert all(c in r["captions"] for c, r in zip(caps, rows))


def test_pretokenize_warns_of_random_weights_and_names_an_image_without_pil(
        coco_images, tmp_path, monkeypatch, capsys):
    root, ann = coco_images
    tvcfg = tcfg.VQConfig(**_VQ)
    out = tmp_path / "rows.jsonl"
    args = ["--image-root", root, "--ann", ann, "--out", str(out), "--size", "32",
            "--device", "cpu"]
    assert tpretok.main(args + ["--limit", "2"], vq_cfg=tvcfg) == 2
    assert "RANDOM VQ weights" in capsys.readouterr().err
    # .npy pixels of the side asked for need no PIL, and give the PNGs' rows
    png = _write_coco(tmp_path / "png", [(32, 32)] * 3, ".png", seed=9)
    npy = _write_coco(tmp_path / "npy", [(32, 32)] * 3, ".npy", seed=9)
    tpretok.main(["--image-root", png[0], "--ann", png[1], "--out", str(tmp_path / "png.jsonl"),
                  "--size", "32", "--device", "cpu"], vq_cfg=tvcfg)
    monkeypatch.setitem(sys.modules, "PIL", None)
    tpretok.main(["--image-root", npy[0], "--ann", npy[1], "--out", str(tmp_path / "npy.jsonl"),
                  "--size", "32", "--device", "cpu"], vq_cfg=tvcfg)
    assert (tmp_path / "npy.jsonl").read_text() == (tmp_path / "png.jsonl").read_text()
    with pytest.raises(ImportError, match=r"img0\.png.*needs PIL"):
        tpretok.main(args, vq_cfg=tvcfg)


def test_training_cli_with_sinks_and_the_native_reader(tmp_path, capsys):
    from omnimamba_tpu_torch.scripts import train as cli

    with pytest.warns(RuntimeWarning, match="wandb unavailable"):
        state, metrics = cli.main(["--config", "config/config_tiny.yaml", "--synthetic-data",
                                   "--max-steps", "1", "--batch-t2i", "2", "--batch-mmu", "1",
                                   "--device", "cpu", "--output-dir", str(tmp_path),
                                   "--tensorboard", "--wandb"])
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    (run,) = list(tmp_path.iterdir())
    assert list((run / "tb").glob("events.out.tfevents.*"))
    assert [json.loads(line)["step"] for line in open(run / "metrics.jsonl")] == [1]
    assert "native mmap reader" in capsys.readouterr().out

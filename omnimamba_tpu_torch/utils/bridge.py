"""Parameters of the JAX package -> parameters of the port.

``from_jax_params`` takes the JAX parameter pytree with every leaf already
turned into a numpy array by the caller, so this module never imports JAX.
What changes on the way:

- layers stacked on axis 0 become a Python list of per-layer dicts;
- in_proj, stored as four column slices ``z | x | bc | dt``, becomes one fused
  ``(d, d_in_proj)`` kernel in that column order, and the LoRA ``B_*``
  factors likewise;
- the conv taps ``weight_x`` / ``weight_bc`` (and biases) become one
  ``weight`` / ``bias`` over the ``x | bc`` channels;
- linear kernels stay ``(in, out)`` (the port applies ``x @ W``);
- VQ conv kernels, the towers' patch kernels and the ldpnet position conv go
  from HWIO to OIHW;
- the towers' blocks, stacked on axis 0, become a list of per-block dicts;
  their ``qkv`` kernel stays fused ``(d, 3d)``;
- an int8-quantized tree (``quantize_decode_params``) keeps its ``q`` leaves
  int8 and its ``scale`` leaves float32 whatever ``dtype`` says; the in_proj
  parts' ``q`` and ``scale`` are concatenated along the columns like dense
  parts, and a tree passed through JAX ``fuse_in_proj`` (``in_proj/fused``)
  is taken as it is.

Every leaf of the input must be consumed: a leaf the port has no place for
(the VQ encoder) raises instead of being dropped. ``to_jax_tree`` undoes
every step for the backbone, the towers and the projector, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from omnimamba_tpu_torch.models.backbone import check_supported
from omnimamba_tpu_torch.models.mamba2 import TASKS
from omnimamba_tpu_torch.utils.device import resolve_device

_IN_PROJ_PARTS = ("z", "x", "bc", "dt")
_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
}


def _flatten(node, path: Tuple = ()) -> Dict[Tuple, np.ndarray]:
    if node is None:
        return {}
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        return {path: np.asarray(node)}
    out: Dict[Tuple, np.ndarray] = {}
    for k, v in items:
        out.update(_flatten(v, path + (k,)))
    return out


class _Leaves:
    """The flattened input; ``take`` converts a leaf and marks it consumed."""

    def __init__(self, tree, dtype: Optional[torch.dtype], device: torch.device):
        self.flat = _flatten(tree)
        self.quantized = {k[:-1] for k in self.flat if k[-1] == "q"}  # {"q", "scale"} entries
        self.dtype, self.device = dtype, device

    def has(self, *path) -> bool:
        return any(k[: len(path)] == path for k in self.flat)

    def take(self, *path) -> torch.Tensor:
        arr = self.flat.pop(path)
        if arr.dtype == np.int8:
            return torch.from_numpy(np.array(arr)).to(self.device)
        if path[-1] == "scale" and path[:-1] in self.quantized:
            return torch.from_numpy(np.array(arr, np.float32)).to(self.device)
        dtype = self.dtype or _TORCH_DTYPES[str(arr.dtype)]
        # numpy has no native bfloat16: widen through float32 (exact)
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return t.to(device=self.device, dtype=dtype)

    def take_tree(self, *path):
        """Convert the whole subtree under ``path``, keeping its structure."""
        if path in self.flat:
            return self.take(*path)
        keys = sorted((k for k in self.flat if k[: len(path)] == path), key=str)
        out: Dict = {}
        for k in keys:
            node = out
            rest = k[len(path):]
            for part in rest[:-1]:
                node = node.setdefault(part, {})
            node[rest[-1]] = self.take(*k)
        return _lists(out)


def _lists(node):
    """Dicts keyed 0..n-1 (flattened lists) back to lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _hwio_to_oihw(node):
    if isinstance(node, dict):
        return {
            k: v.permute(3, 2, 0, 1).contiguous()
            if k == "kernel" and isinstance(v, torch.Tensor) and v.dim() == 4
            else _hwio_to_oihw(v)
            for k, v in node.items()
        }
    if isinstance(node, list):
        return [_hwio_to_oihw(v) for v in node]
    return node


def _oihw_to_hwio(node):
    if isinstance(node, dict):
        return {
            k: v.permute(2, 3, 1, 0).contiguous()
            if k == "kernel" and isinstance(v, torch.Tensor) and v.dim() == 4
            else _oihw_to_hwio(v)
            for k, v in node.items()
        }
    return node


def _unstack(node, n: int) -> list:
    """A tree whose leaves are stacked on axis 0 -> a list of ``n`` trees, one
    per index; every leaf must hold ``n`` entries."""
    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        if node.shape[0] != n:
            raise ValueError(f"stacked leaf has {node.shape[0]} entries, expected {n}")
        return node[i].contiguous()

    return [pick(node, i) for i in range(n)]


def _unstack_blocks(tower: Dict) -> Dict:
    """A tower whose ``blocks`` leaves are stacked on axis 0 -> a list of
    per-block dicts."""
    first = tower["blocks"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return {**tower, "blocks": _unstack(tower["blocks"], first.shape[0])}


def _in_proj(leaves: _Leaves, mix: Tuple):
    """The fused in_proj kernel, dense or ``{"q", "scale"}``, from the four
    column slices or from JAX ``fuse_in_proj``'s ``fused`` entry."""
    if leaves.has(*mix, "in_proj", "fused"):
        return leaves.take_tree(*mix, "in_proj", "fused")
    parts = [leaves.take_tree(*mix, "in_proj", p) for p in _IN_PROJ_PARTS]
    if isinstance(parts[0], dict):
        return {k: torch.cat([part[k] for part in parts], dim=-1) for k in ("q", "scale")}
    return torch.cat(parts, dim=-1)


def _bridge_layers(leaves: _Leaves, n_layer: int):
    base = ("mamba", "layers")
    mix = base + ("mixer",)
    cat = lambda *ts: torch.cat(ts, dim=-1)  # noqa: E731
    stacked = {
        "norm": {"weight": leaves.take(*base, "norm", "weight")},
        "mixer": {
            "in_proj": {"kernel": _in_proj(leaves, mix)},
            "conv": {
                "weight": cat(leaves.take(*mix, "conv", "weight_x"),
                              leaves.take(*mix, "conv", "weight_bc")),
                "bias": cat(leaves.take(*mix, "conv", "bias_x"),
                            leaves.take(*mix, "conv", "bias_bc")),
            },
            "dt_bias": leaves.take(*mix, "dt_bias"),
            "A_log": leaves.take(*mix, "A_log"),
            "D": leaves.take(*mix, "D"),
            "norm": {"weight": leaves.take(*mix, "norm", "weight")},
            "out_proj": {"kernel": leaves.take_tree(*mix, "out_proj", "kernel")},
        },
    }
    if leaves.has(*mix, "lora"):
        lora = {}
        for task in TASKS:
            lora[f"{task}_A"] = leaves.take(*mix, "lora", f"{task}_A")
            lora[f"{task}_B"] = cat(
                *[leaves.take(*mix, "lora", f"{task}_B_{p}") for p in _IN_PROJ_PARTS])
        stacked["mixer"]["lora"] = lora

    return _unstack(stacked, n_layer)


def from_jax_params(
    params_numpy: Dict,
    model,
    *,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> Dict:
    """Convert ``{"mamba": ..., "vision": ..., "projector": ..., "vq": ...}``
    (numpy leaves; any of them) for
    ``model`` (an ``OmniMambaModel`` of the port). ``dtype=None`` keeps each
    leaf's own float type. Raises ``ValueError`` listing every leaf that was
    not consumed."""
    check_supported(model.cfg)
    leaves = _Leaves(params_numpy, dtype, resolve_device(device))
    out: Dict = {}

    if leaves.has("mamba"):
        mamba: Dict = {}
        for key in ("embedding", "img_embeddings", "pos_embed", "caption_embed",
                    "mmu_pos_embed", "norm_f"):
            if leaves.has("mamba", key):
                mamba[key] = leaves.take_tree("mamba", key)
        mamba["layers"] = _bridge_layers(leaves, model.cfg.n_layer)
        out["mamba"] = mamba

    if leaves.has("vision"):
        out["vision"] = {
            name: _hwio_to_oihw(_unstack_blocks(leaves.take_tree("vision", name)))
            for name in ("dino", "siglip") if leaves.has("vision", name)
        }
    if leaves.has("projector"):
        out["projector"] = _hwio_to_oihw(leaves.take_tree("projector"))

    if leaves.has("vq"):
        vq = {"codebook": leaves.take("vq", "codebook")}
        for key in ("decoder", "post_quant_conv"):
            vq[key] = _hwio_to_oihw(leaves.take_tree("vq", key))
        out["vq"] = vq

    if leaves.flat:
        left = sorted("/".join(map(str, k)) for k in leaves.flat)
        raise ValueError(
            f"{len(left)} parameter leaves have no place in the port yet (the VQ "
            "encoder arrives with a later slice): "
            + ", ".join(left[:8]) + (" ..." if len(left) > 8 else "")
        )
    return out


def to_jax_tree(port_tree: Dict, model) -> Dict:
    """The inverse of ``from_jax_params`` for the backbone, the towers and the
    projector: a tree shaped like the port's (parameters, gradients or
    updated parameters) as numpy arrays under the JAX package's names. The
    fused in_proj kernel and LoRA B factors are cut back into their ``z | x |
    bc | dt`` column slices, the conv taps and biases into ``x | bc``, the
    per-layer and per-block dicts are stacked on a leading axis and OIHW
    kernels go back to HWIO. Tests use it to compare the two packages leaf
    by leaf."""
    if not set(port_tree) <= {"mamba", "vision", "projector"}:
        raise ValueError(
            f"to_jax_tree converts the backbone, the towers and the projector, got {sorted(port_tree)}")
    mixer_cfg = model.cfg.mixer
    di, gn2, H = mixer_cfg.d_inner, 2 * mixer_cfg.ngroups * mixer_cfg.d_state, mixer_cfg.nheads
    widths = dict(zip(_IN_PROJ_PARTS, (di, di, gn2, H)))

    def arr(t):  # always a copy: the port updates its parameters in place
        t = t.detach().cpu()
        return np.array((t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy())

    def tree(node):
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return arr(node)

    def columns(t, sizes):
        return [arr(p) for p in torch.split(t, list(sizes), dim=-1)]

    def layer(p):
        mix = p["mixer"]
        wx, wbc = columns(mix["conv"]["weight"], (di, gn2))
        bx, bbc = columns(mix["conv"]["bias"], (di, gn2))
        out = {
            "in_proj": dict(zip(_IN_PROJ_PARTS,
                                columns(mix["in_proj"]["kernel"], widths.values()))),
            "conv": {"weight_x": wx, "weight_bc": wbc, "bias_x": bx, "bias_bc": bbc},
            "dt_bias": arr(mix["dt_bias"]), "A_log": arr(mix["A_log"]), "D": arr(mix["D"]),
            "norm": {"weight": arr(mix["norm"]["weight"])},
            "out_proj": {"kernel": arr(mix["out_proj"]["kernel"])},
        }
        if "lora" in mix:
            lora = {}
            for task in TASKS:
                lora[f"{task}_A"] = arr(mix["lora"][f"{task}_A"])
                for part, cols in zip(_IN_PROJ_PARTS,
                                      columns(mix["lora"][f"{task}_B"], widths.values())):
                    lora[f"{task}_B_{part}"] = cols
            out["lora"] = lora
        return {"norm": {"weight": arr(p["norm"]["weight"])}, "mixer": out}

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    result = {}
    if "mamba" in port_tree:
        mamba = port_tree["mamba"]
        out = {k: tree(v) for k, v in mamba.items() if k != "layers"}
        out["layers"] = stack([layer(p) for p in mamba["layers"]])
        result["mamba"] = out
    if "vision" in port_tree:
        result["vision"] = {}
        for name, tower in port_tree["vision"].items():
            tower = _oihw_to_hwio(tower)
            conv = {k: tree(v) for k, v in tower.items() if k != "blocks"}
            conv["blocks"] = stack([tree(b) for b in tower["blocks"]])
            result["vision"][name] = conv
    if "projector" in port_tree:
        result["projector"] = tree(_oihw_to_hwio(port_tree["projector"]))
    return result

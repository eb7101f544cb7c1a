"""Training checkpoints on ``torch.save``.

Counterpart of ``omnimamba_tpu/utils/checkpoint.py`` (which rides Orbax): one
file per step, ``<directory>/step_<n>.pt``, holding the parameters by path,
the optimizer's state dict, the step and, where given, the dropout
generator's state. Files are written under a temporary name and renamed, so
a reader sees a whole checkpoint or none; the oldest are removed beyond
``save_total_limit``. ``restore`` loads with ``weights_only=True`` (tensors
and plain containers only, nothing is unpickled into code) and copies **into**
the tensors of the state it is given, so the optimizer keeps pointing at the
live parameters.

Across ranks (a process group is initialised) every rank calls ``save`` and
``restore``. ``save`` gathers each fsdp and tp slice and its AdamW moments
whole (over fsdp, then over tp), so the file is the one a card writes,
whatever the mesh; rank 0 alone
copies them to host memory and writes the file, and every rank waits at a
barrier until it is in place. The file also holds
every rank's generator state (``"generators"``, by rank; ``"generator"`` is
rank 0's). ``restore`` copies each rank's slice (tp, then fsdp) out of the
whole leaves and moments, so a checkpoint moves between world sizes and meshes; a rank takes
its own generator state where the file has one for its rank and keeps its
own stream otherwise.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from omnimamba_tpu_torch.parallel.sharding import local_part, whole_like, whole_tensor
from omnimamba_tpu_torch.train.optimizer import named_leaves

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, save_total_limit: int = 5):
        self.directory = os.path.abspath(directory)
        self.save_total_limit = save_total_limit
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, generator: Optional[torch.Generator] = None) -> None:
        """Write ``state`` (a ``TrainState``) as the checkpoint of ``step``
        (across ranks: every rank calls it, rank 0 writes)."""
        ranked = dist.is_available() and dist.is_initialized()
        writes = not ranked or dist.get_rank() == 0
        # every rank takes part in each gather; only the writer keeps a host copy
        params = {path: _host(whole_tensor(leaf), writes)
                  for path, leaf in named_leaves(state.params)}
        opt_state = _whole_moments(state.opt_state, keep=writes)
        gen_state = None if generator is None else generator.get_state()
        generators = [gen_state]
        if ranked:
            generators = [None] * dist.get_world_size()
            dist.all_gather_object(generators, gen_state)
        if writes:
            payload = {"step": int(state.step), "params": params, "opt_state": opt_state,
                       "generator": generators[0], "generators": generators}
            tmp = self._path(step) + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
            if self.save_total_limit and self.save_total_limit > 0:
                for old in self.all_steps()[: -self.save_total_limit]:
                    os.remove(self._path(old))
        if ranked:
            dist.barrier()

    def restore(self, state_template: Any, step: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> Any:
        """Load the checkpoint of ``step`` (default: the latest) into the
        parameters and the optimizer of ``state_template`` (and into
        ``generator``) and return the state with the saved step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        saved = payload["params"]
        live = dict(named_leaves(state_template.params))
        if set(saved) != set(live):
            raise ValueError(
                f"checkpoint and state differ in {sorted(set(saved) ^ set(live))[:8]} ...")
        with torch.no_grad():
            for path, leaf in live.items():
                leaf.copy_(_own_part(saved[path], leaf).to(leaf.dtype))
        tx = state_template.opt_state
        tx.load_state_dict(_own_moments(payload["opt_state"], tx))
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        gens = payload.get("generators") or [payload["generator"]]
        if generator is not None and rank < len(gens) and gens[rank] is not None:
            generator.set_state(gens[rank])
        return state_template._replace(step=payload["step"])

    def close(self) -> None:
        """Nothing is held open; kept for the JAX manager's interface."""


def _own_part(full: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a saved whole leaf for the live ``leaf`` (its tp
    slice, then its fsdp slice; the whole leaf where ``leaf`` is whole)."""
    return local_part(full, leaf)


def _optimizer_params(tx) -> List[torch.Tensor]:
    """The optimizer's parameters in its state dict's index order."""
    return [p for group in tx.param_groups for p in group["params"]]


def _host(t: torch.Tensor, keep: bool) -> Optional[torch.Tensor]:
    """A host copy of ``t`` where ``keep``, else None (``t`` is dropped)."""
    return t.cpu() if keep else None


def _whole_moments(tx, keep: bool = True) -> dict:
    """``tx.state_dict()`` with every moment of a tp or fsdp slice gathered whole
    and copied to the host (every rank gathers, in index order; where
    ``keep`` is False the moments are dropped once gathered and come back as
    None)."""
    sd = tx.state_dict()
    params = _optimizer_params(tx)
    state = {}
    for idx, entry in sd["state"].items():
        p = params[idx]
        state[idx] = {k: (_host(whole_like(v, p), keep)
                          if torch.is_tensor(v) and v.shape == p.shape and v.dim() else v)
                      for k, v in entry.items()}
    return {**sd, "state": state}


def _own_moments(sd: dict, tx) -> dict:
    """A saved (whole) optimizer state dict cut to this rank's slices."""
    params = _optimizer_params(tx)
    state = {}
    for idx, entry in sd["state"].items():
        p = params[int(idx)]
        state[idx] = {k: (_own_part(v, p) if torch.is_tensor(v) and v.dim() else v)
                      for k, v in entry.items()}
    return {**sd, "state": state}


def load_params(path: str, params: Any) -> Any:
    """Copy the parameters of a checkpoint written by ``CheckpointManager``
    (a ``step_<n>.pt`` file, or a directory: its latest step) into the
    tensors of ``params``, cast to their types, and return ``params``. A saved
    leaf with no place in ``params`` or another shape raises; leaves the
    checkpoint does not hold (the vision towers of a text-to-image run) keep
    their values."""
    if os.path.isdir(path):
        manager = CheckpointManager(path)
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = manager._path(step)
    saved = torch.load(path, map_location="cpu", weights_only=True)["params"]
    live = dict(named_leaves(params))
    unknown = sorted(set(saved) - set(live))
    if unknown:
        raise ValueError(f"{len(unknown)} checkpoint leaves have no place in the model: {unknown[:8]}")
    with torch.no_grad():
        for name, tensor in saved.items():
            if tuple(tensor.shape) != tuple(live[name].shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(tensor.shape)}, model {tuple(live[name].shape)}")
            live[name].copy_(tensor.to(live[name].dtype))
    return params

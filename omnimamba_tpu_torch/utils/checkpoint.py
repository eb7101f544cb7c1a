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
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

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
        """Write ``state`` (a ``TrainState``) as the checkpoint of ``step``."""
        payload = {
            "step": int(state.step),
            "params": {path: leaf.detach().cpu() for path, leaf in named_leaves(state.params)},
            "opt_state": state.opt_state.state_dict(),
            "generator": None if generator is None else generator.get_state(),
        }
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self.save_total_limit and self.save_total_limit > 0:
            for old in self.all_steps()[: -self.save_total_limit]:
                os.remove(self._path(old))

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
                leaf.copy_(saved[path].to(leaf.dtype))
        state_template.opt_state.load_state_dict(payload["opt_state"])
        if generator is not None and payload["generator"] is not None:
            generator.set_state(payload["generator"])
        return state_template._replace(step=payload["step"])

    def close(self) -> None:
        """Nothing is held open; kept for the JAX manager's interface."""

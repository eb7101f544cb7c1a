"""Chat prompt builders for understanding data: the port's copy of
``omnimamba_tpu/data/prompt_builder.py``. The Mamba builder wraps turns as
``In: {msg}\\nOut: `` / ``{msg}<|endoftext|>`` with no BOS.
"""

from __future__ import annotations

from typing import Optional


class PromptBuilder:
    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        self.model_family = model_family
        self.system_prompt = system_prompt

    def add_turn(self, role: str, message: str) -> str:
        raise NotImplementedError

    def get_potential_prompt(self, user_msg: str) -> str:
        raise NotImplementedError

    def get_prompt(self) -> str:
        raise NotImplementedError


class MambaPromptBuilder(PromptBuilder):
    """The Mamba family's prompt strings, byte for byte."""

    def __init__(self, model_family: str, system_prompt: Optional[str] = None) -> None:
        super().__init__(model_family, system_prompt)
        self.bos, self.eos = "", "<|endoftext|>"
        self.wrap_human = lambda msg: f"In: {msg}\nOut: "
        self.wrap_gpt = lambda msg: f"{msg if msg != '' else ' '}{self.eos}"
        self.prompt, self.turn_count = "", 0

    def add_turn(self, role: str, message: str) -> str:
        want = "human" if self.turn_count % 2 == 0 else "gpt"
        if role != want:
            raise ValueError(f"turn {self.turn_count} must be {want!r}, got {role!r}")
        message = message.replace("<image>", "").strip()
        if (self.turn_count % 2) == 0:
            human_message = self.wrap_human(message)
            if self.turn_count != 0:
                human_message = "\n" + human_message
            wrapped = human_message
        else:
            wrapped = self.wrap_gpt(message)
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        return (self.prompt + self.wrap_human(message)).removeprefix(self.bos)

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.bos)

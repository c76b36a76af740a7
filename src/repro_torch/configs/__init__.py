"""Architecture registry of the port: the five dense global-attention
configs that the dense serving slice runs.  Each module exports
``CONFIG`` (the published config) and ``reduced()`` (a small
same-family config for CPU tests).  Dashes and underscores are
interchangeable in names.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.core.config import ModelConfig

_ARCHS = ["gemma_2b", "gemma_7b", "qwen3_32b", "llama2_70b", "gpt3_175b"]


def _module(name: str):
    norm = name.replace("-", "_").replace(".", "_")
    if norm not in _ARCHS:
        raise NotImplementedError(
            f"{name!r} is not ported yet: the port serves the dense "
            f"global-attention configs {list_archs()}; the other families "
            "(MoE, SSM, hybrid, windowed, VLM, encoder-decoder) are queued "
            "in ROADMAP.md")
    return importlib.import_module(f"repro_torch.configs.{norm}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced_config(name: str) -> ModelConfig:
    return _module(name).reduced()


def list_archs() -> List[str]:
    return [n.replace("_", "-") for n in _ARCHS]

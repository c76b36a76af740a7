"""Model factory of the port."""
from __future__ import annotations

from repro_torch.core.config import Family, ModelConfig
from repro_torch.models.lm import DecoderModel

_QUEUED = {Family.MOE: "MoE (ROADMAP.md queue 1, item 9)",
           Family.SSM: "SSM and hybrid (ROADMAP.md queue 1, item 10)",
           Family.HYBRID: "SSM and hybrid (ROADMAP.md queue 1, item 10)",
           Family.VLM: "VLM and encoder-decoder (ROADMAP.md queue 1, item 11)",
           Family.ENCDEC: "VLM and encoder-decoder (ROADMAP.md queue 1, "
                          "item 11)",
           Family.AUDIO: "VLM and encoder-decoder (ROADMAP.md queue 1, "
                         "item 11)"}


def build_model(cfg: ModelConfig, *, device="cuda") -> DecoderModel:
    """The dense decoder on ``device`` (the card unless ``"cpu"``)."""
    if cfg.family in _QUEUED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family.value} is not ported yet: "
            f"{_QUEUED[cfg.family]}")
    return DecoderModel(cfg, device=device)

"""Architecture hyperparameters for the PyTorch port.

A copy of the architecture half of ``repro.core.config`` (``Family``,
``Activation``, ``ModelConfig``): the port imports nothing of the JAX
package.  The TPU ``ChipSpec`` is deliberately not carried over — device
numbers in this package come from runs on the card.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENCDEC = "encdec"
    VLM = "vlm"
    AUDIO = "audio"


class Activation(str, enum.Enum):
    SWIGLU = "swiglu"   # silu(xW1) * xW3
    GEGLU = "geglu"     # gelu(xW1) * xW3
    GELU = "gelu"       # plain gelu(xW1) (classic transformer / GPT-3)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (field-for-field the reference's)."""

    name: str
    family: Family
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    m_rope_sections: Optional[Tuple[int, int, int]] = None
    sliding_window: Optional[int] = None
    local_global_pattern: int = 0
    logit_softcap: Optional[float] = None
    # --- mlp ---
    d_ff: int = 0
    activation: Activation = Activation.SWIGLU
    # --- moe ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    # --- ssm (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2) ---
    attn_every: int = 0
    # --- enc-dec ---
    encoder_layers: int = 0
    # --- modality frontend stubs ---
    frontend_dim: int = 0
    # --- embedding ---
    tie_embeddings: bool = True
    pad_vocab_to_multiple: int = 256
    # --- norm ---
    rms_eps: float = 1e-6
    # --- provenance ---
    source: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.pad_vocab_to_multiple)

"""Gemma-2B — dense MQA (kv=1), GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.core.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family=Family.DENSE,
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,                   # MQA on 2b
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    activation=Activation.GEGLU,
    rope_theta=10_000.0,
    source="arXiv:2403.08295; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-reduced",
        family=Family.DENSE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation=Activation.GEGLU,
        pad_vocab_to_multiple=16,
    )

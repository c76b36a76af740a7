"""Gemma-7B — dense MHA (kv=16), GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.core.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family=Family.DENSE,
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    activation=Activation.GEGLU,
    rope_theta=10_000.0,
    source="arXiv:2403.08295; hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-reduced",
        family=Family.DENSE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation=Activation.GEGLU,
        pad_vocab_to_multiple=16,
    )

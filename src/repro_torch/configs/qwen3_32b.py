"""Qwen3-32B — dense GQA transformer with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.core.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family=Family.DENSE,
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151_936,
    activation=Activation.SWIGLU,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-8B (scaled per assignment); hf",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-reduced",
        family=Family.DENSE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation=Activation.SWIGLU,
        qk_norm=True,
        tie_embeddings=False,
        pad_vocab_to_multiple=16,
    )

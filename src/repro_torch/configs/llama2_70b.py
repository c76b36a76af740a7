"""Llama-2-70B — the paper's MLPerf LoRA fine-tuning workload (§6.6,
Table 11). [arXiv:2307.09288; hf]"""
from repro_torch.core.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="llama2-70b",
    family=Family.DENSE,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32_000,
    activation=Activation.SWIGLU,
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2307.09288; MLPerf Training v4.1 LoRA (paper Table 11)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama2-70b-reduced",
        family=Family.DENSE,
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation=Activation.SWIGLU,
        tie_embeddings=False,
        pad_vocab_to_multiple=16,
    )

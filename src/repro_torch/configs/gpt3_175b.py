"""GPT-3 175B — the paper's own MLPerf Training v4.1 pretraining workload
(§6.6, Table 9). [arXiv:2005.14165 + MLPerf v4.1 reference]"""
from repro_torch.core.config import Activation, Family, ModelConfig

CONFIG = ModelConfig(
    name="gpt3-175b",
    family=Family.DENSE,
    num_layers=96,
    d_model=12288,
    num_heads=96,
    num_kv_heads=96,
    head_dim=128,
    d_ff=49152,
    vocab_size=51_200,
    activation=Activation.GELU,
    rope_theta=10_000.0,               # MLPerf reference uses RoPE variant
    tie_embeddings=True,
    source="arXiv:2005.14165; MLPerf Training v4.1 (paper Table 9)",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gpt3-175b-reduced",
        family=Family.DENSE,
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        activation=Activation.GELU,
        pad_vocab_to_multiple=16,
    )

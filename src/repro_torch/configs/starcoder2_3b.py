"""StarCoder2 3B [arXiv:2402.19173]. GQA kv=2, RoPE, sliding window 4096,
LayerNorm with bias, plain GELU MLP (non-gated)."""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    use_bias=True,
    sliding_window=4096,
    rope_theta=999999.4,
    fed=FedConfig(mode="client_parallel"),
    source="arXiv:2402.19173",
)

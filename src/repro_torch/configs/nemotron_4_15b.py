"""Nemotron-4 15B [arXiv:2402.16819]. GQA kv=8, squared-ReLU non-gated MLP,
LayerNorm, RoPE (partial rope in the original; full rope here), 256k vocab."""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    activation="sq_relu",
    gated_mlp=False,
    norm="layernorm",
    use_bias=True,
    tie_embeddings=False,
    fed=FedConfig(mode="client_parallel"),
    source="arXiv:2402.16819",
)

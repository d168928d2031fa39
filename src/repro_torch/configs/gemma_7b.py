"""Gemma 7B [arXiv:2403.08295]. GeGLU, head_dim=256, kv=16 (MQA on 2b),
embeddings scaled by sqrt(d_model), tied embeddings."""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    activation="geglu",
    gated_mlp=True,
    norm="rmsnorm",
    embed_scale=True,
    tie_embeddings=True,
    fed=FedConfig(mode="client_parallel"),
    source="arXiv:2403.08295",
)

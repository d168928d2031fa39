"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01 family]. GQA kv=8,
no biases, parallel attn+FFN residual block, untied head over 256k vocab."""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    activation="silu",
    gated_mlp=True,
    norm="layernorm",
    use_bias=False,
    parallel_residual=True,
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    fed=FedConfig(mode="client_sequential"),
    source="hf:CohereForAI/c4ai-command-r-v01 (R+ dims)",
)

"""MusicGen medium [arXiv:2306.05284]. Decoder-only over EnCodec tokens:
4 codebooks (delay pattern), summed codebook embeddings, 4 parallel LM heads
over vocab=2048. Sinusoidal positions, LayerNorm, GELU. The text-conditioning
cross-attention (T5 frontend) is omitted per the modality-frontend carve-out.
"""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    use_bias=True,
    pos_emb="sinusoidal",
    n_codebooks=4,
    tie_embeddings=False,
    fed=FedConfig(mode="client_parallel"),
    source="arXiv:2306.05284",
)

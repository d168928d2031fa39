"""LLaVA-NeXT 34B language backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf,
scaled per llava-v1.6-34b / Yi-34B dims].

VLM: anyres-tiled vision frontend is a stub — ``input_specs`` supplies
(B, n_patches, d_model) projected patch embeddings which the backbone
prepends to the token embeddings (loss masked to text positions).
"""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    n_patches=576,  # one 24x24 anyres tile of projected CLIP patches
    fed=FedConfig(mode="client_sequential"),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34b variant dims)",
)

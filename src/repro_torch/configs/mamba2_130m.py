"""Mamba2 130M [arXiv:2405.21060]. Attention-free; SSD (state-space duality)
chunked algorithm; d_state=128, expand=2 (d_inner=1536), head_dim=64
(24 SSD heads), 1 group, conv width 4."""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,             # no separate MLP block (mamba block is the mixer)
    vocab=50280,
    norm="rmsnorm",
    pos_emb="none",
    ssm_d_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    ssm_d_conv=4,
    fed=FedConfig(mode="client_parallel"),
    source="arXiv:2405.21060",
)

"""Hymba 1.5B [arXiv:2411.13676]. Hybrid: every layer runs attention heads
and Mamba(2)-style SSM heads **in parallel**, outputs normalized per branch
then mean-combined. Attention uses SWA 2048 (Hymba uses SWA in most layers +
meta tokens; the few-global-layers detail is simplified, as in the
reference). ssm_state=16.
"""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    sliding_window=2048,
    ssm_d_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    fed=FedConfig(mode="client_parallel"),
    source="arXiv:2411.13676",
)

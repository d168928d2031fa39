"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]. MLA with kv_lora=512,
qk_rope=64, no q compression; MoE: 64 routed experts top-6 + 2 shared,
moe_d_ff=1408; first layer dense (d_ff=10944).

Note: the assignment line reads "MoE 64e top-6 ... 2 shared+160 routed";
160 routed belongs to full DeepSeek-V2 — the reference follows the
primary spec (64 routed) per the V2-Lite model card.
"""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,   # MLA: heads share the compressed cache; kept for record
    head_dim=192,    # qk_nope(128) + qk_rope(64)
    d_ff=10944,      # dense (first) layer FFN
    vocab=102400,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    use_mla=True,
    q_lora_rank=0,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
    router_score="softmax",
    # client_sequential: the reference's choice, so that its
    # expert-parallel MoE path applies in training
    fed=FedConfig(mode="client_sequential", clients_per_round=8),
    source="arXiv:2405.04434",
)

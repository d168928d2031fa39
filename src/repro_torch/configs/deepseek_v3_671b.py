"""DeepSeek-V3 671B [arXiv:2412.19437]. MLA (q_lora=1536, kv_lora=512,
qk_rope=64), MoE: 256 routed top-8 (sigmoid router w/ aux-free bias —
implemented as sigmoid scoring + aux loss) + 1 shared expert, moe_d_ff=2048;
first 3 layers dense (d_ff=18432); MTP depth 1."""
from repro_torch.configs.base import ArchConfig, FedConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,  # MLA: full heads over the shared compressed cache
    head_dim=192,    # qk_nope(128) + qk_rope(64)
    d_ff=18432,      # dense (first 3) layers
    vocab=129280,
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_k_dense=3,
    router_score="sigmoid",
    mtp_depth=1,
    fed=FedConfig(mode="client_sequential", clients_per_round=4),
    source="arXiv:2412.19437",
)

"""Architecture / run configuration dataclasses, counterpart of
``repro/configs/base.py``.

``ArchConfig`` holds every field of the reference's, under its names and
defaults; ``reduced()`` is the reference's derivation of the CPU smoke-test
variant (2 layers, d_model <= 256, <= 4 experts).  The reference's
``remat``, ``seq_parallel``, ``remat_attention`` and ``expand_gqa`` steer
jax's rematerialisation and GSPMD's sharding; the port keeps them for
parity and reads none of them.  ``get_config`` knows every architecture
of ``ARCH_IDS``, all of which the port runs (``PORTED_IDS``).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace

# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Federated-learning configuration (the paper's knobs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FedConfig:
    """Paper knobs: rounds of E local SGD steps, scheme-based aggregation."""

    scheme: str = "C"              # "A" | "B" | "C"  (Section 4.1)
    local_epochs: int = 2          # E
    clients_per_round: int = 8     # C simulated clients in one round
    # client_parallel: clients batched over one axis (paper breadth);
    # client_sequential: one client at a time
    mode: str = "client_parallel"
    # fast-reboot (Cor 4.0.2): arriving device coefficient boost.
    reboot_boost: float = 3.0
    # staircase learning rate eta_tau = eta0 / tau (Sec 5.1).
    eta0: float = 0.01


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    # --- attention ---
    n_heads: int = 0               # 0 => attention-free (pure SSM)
    n_kv_heads: int = 0
    head_dim: int = 128
    rope_theta: float = 10000.0
    pos_emb: str = "rope"          # rope | sinusoidal | none
    sliding_window: int = 0        # 0 => full attention
    attn_logit_softcap: float = 0.0
    # --- mlp ---
    d_ff: int = 0
    activation: str = "silu"       # silu | gelu | geglu | sq_relu
    gated_mlp: bool = True         # gated (SwiGLU/GeGLU) vs plain 2-matmul
    # --- norm / structure ---
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    use_bias: bool = False
    parallel_residual: bool = False  # cohere-style parallel attn+ffn
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    tie_embeddings: bool = True
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0           # 0 => direct q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    n_experts: int = 0             # routed experts; 0 => dense FFN
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0         # leading layers with dense FFN
    router_score: str = "softmax"  # softmax | sigmoid (v3)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # --- SSM (mamba2 SSD) ---
    ssm_d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_d_conv: int = 4
    ssm_chunk: int = 256
    # --- multimodal stub frontends ---
    n_patches: int = 0             # vlm: patch embeddings prepended
    n_codebooks: int = 0           # audio: EnCodec codebooks (summed embed)
    # --- extras ---
    mtp_depth: int = 0             # deepseek-v3 multi-token prediction
    dtype: str = "bfloat16"
    # --- federated / distribution ---
    fed: FedConfig = field(default_factory=FedConfig)
    # the reference's rematerialisation and sharding switches: kept with
    # their defaults, read by nothing in the port
    remat: bool = True
    seq_parallel: bool = False
    remat_attention: bool = True
    expand_gqa: bool = True
    attn_impl: str = "chunked"     # "chunked" (plain PyTorch) or "flash"
    #                                (the flash_attention kernel: prefill)
    source: str = ""               # citation

    # -- derived ----------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256, as the reference stores the
        embedding and head; logits are sliced back to ``vocab``."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:      # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_d_state else 0

    @property
    def moe_layers(self) -> int:
        return (self.n_layers - self.first_k_dense) if self.n_experts else 0

    @property
    def dense_layers(self) -> int:
        return self.n_layers - self.moe_layers

    def supports_shape(self, shape_name: str) -> bool:
        """long_500k only for sub-quadratic archs."""
        if shape_name != "long_500k":
            return True
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=256, <=4 experts."""
        d = min(self.d_model, 256)
        hd = 32 if self.n_heads else self.head_dim
        n_h = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_h // 2)) if self.n_kv_heads else 0
        changes = dict(
            n_layers=2,
            d_model=d,
            vocab=min(self.vocab, 512),
            n_heads=n_h,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
            remat=False,
            fed=replace(self.fed, clients_per_round=4, local_epochs=2),
        )
        if self.use_mla:
            changes.update(
                q_lora_rank=64 if self.q_lora_rank else 0,
                kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
                head_dim=48,  # qk_nope + qk_rope
            )
        if self.n_experts:
            changes.update(
                n_experts=4,
                top_k=min(self.top_k, 2),
                n_shared_experts=min(self.n_shared_experts, 1),
                moe_d_ff=2 * d,
                first_k_dense=min(self.first_k_dense, 1),
            )
        if self.ssm_d_state:
            changes.update(ssm_d_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.n_patches:
            changes.update(n_patches=8)
        if self.mtp_depth:
            changes.update(mtp_depth=1)
        return replace(self, **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = [
    "llava-next-34b",
    "gemma-7b",
    "hymba-1.5b",
    "starcoder2-3b",
    "mamba2-130m",
    "command-r-plus-104b",
    "musicgen-medium",
    "deepseek-v2-lite-16b",
    "nemotron-4-15b",
    "deepseek-v3-671b",
]

PAPER_IDS = ["mnist_mlp", "emnist_cnn", "synthetic_lr"]

# the architectures the port runs: all of them
PORTED_IDS = list(ARCH_IDS)


def get_config(arch_id: str) -> ArchConfig:
    """The ``CONFIG`` of ``repro_torch/configs/<arch_id>.py``."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def all_configs() -> dict:
    """Every architecture's config, by id."""
    return {a: get_config(a) for a in ARCH_IDS}

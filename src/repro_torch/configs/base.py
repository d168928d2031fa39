"""Architecture configuration, counterpart of ``repro/configs/base.py``.

``ArchConfig`` holds the fields of the reference's that the port's serving
paths read (the dense GQA family and Mamba2's SSD), under the reference's
names and defaults; ``reduced()`` is the reference's derivation for such a
config.  The MLA, MoE, multimodal, multi-token-prediction and federated
fields come with the slices that read them.  ``get_config`` knows the
architectures the port runs so far.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

# the architectures the port runs; the others come with later slices
PORTED_IDS = ["nemotron-4-15b", "mamba2-130m"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm (the others: later slices)
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
    # --- SSM (mamba2 SSD) ---
    ssm_d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_d_conv: int = 4
    ssm_chunk: int = 256
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"     # "chunked" (plain PyTorch) or "flash"
    #                                (the flash_attention kernel: prefill)
    source: str = ""               # citation

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

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model<=256, head dim 32; SSM
        state 16, SSM head dim 32 and chunks of 32."""
        d = min(self.d_model, 256)
        hd = 32 if self.n_heads else self.head_dim
        n_h = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_h // 2)) if self.n_kv_heads else 0
        changes = {}
        if self.ssm_d_state:
            changes.update(ssm_d_state=16, ssm_head_dim=32, ssm_chunk=32)
        return replace(
            self,
            n_layers=2,
            d_model=d,
            vocab=min(self.vocab, 512),
            n_heads=n_h,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
            **changes,
        )


def get_config(arch_id: str) -> ArchConfig:
    """The ``CONFIG`` of ``repro_torch/configs/<arch_id>.py``, for the
    architectures in ``PORTED_IDS``."""
    if arch_id not in PORTED_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ported: {PORTED_IDS}); the other "
            f"LM families come with later slices of the port")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG

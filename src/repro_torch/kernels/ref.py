"""Plain PyTorch oracles of the port's kernels, under the names of the
reference's ``repro/kernels/ref.py``: each is the plain version kept
beside its kernel, the allclose target of the kernel on the card."""
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as flash_attention_ref
from repro_torch.kernels.masked_sgd import masked_sgd_plain as masked_sgd_ref
from repro_torch.kernels.ssd_chunk import \
    ssd_intra_chunk_plain as ssd_intra_chunk_ref
from repro_torch.kernels.weighted_agg import \
    weighted_agg_plain as weighted_agg_ref
from repro_torch.kernels.weighted_agg import \
    weighted_agg_quant_plain as weighted_agg_quant_ref
from repro_torch.kernels.weighted_agg import \
    weighted_agg_quant_sharded_plain as weighted_agg_quant_sharded_ref
from repro_torch.kernels.weighted_agg import \
    weighted_agg_sharded_plain as weighted_agg_sharded_ref

__all__ = ["weighted_agg_ref", "weighted_agg_quant_ref",
           "weighted_agg_sharded_ref", "weighted_agg_quant_sharded_ref",
           "masked_sgd_ref", "flash_attention_ref", "ssd_intra_chunk_ref"]

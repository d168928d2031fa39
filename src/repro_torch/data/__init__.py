from repro_torch.data.images import (iid_partition, label_sorted_partition,
                                     make_class_dataset)
from repro_torch.data.synthetic import synthetic_federation
from repro_torch.data.tokens import fed_lm_batches

__all__ = ["make_class_dataset", "label_sorted_partition", "iid_partition",
           "synthetic_federation", "fed_lm_batches"]

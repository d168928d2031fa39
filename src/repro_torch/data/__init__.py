from repro_torch.data.images import (iid_partition, label_sorted_partition,
                                     make_class_dataset)
from repro_torch.data.synthetic import synthetic_federation

__all__ = ["make_class_dataset", "label_sorted_partition", "iid_partition",
           "synthetic_federation"]

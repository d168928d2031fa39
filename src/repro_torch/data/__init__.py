from repro_torch.data.images import label_sorted_partition, make_class_dataset

__all__ = ["make_class_dataset", "label_sorted_partition"]

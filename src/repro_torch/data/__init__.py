from repro_torch.data.pipeline import (
    Dataset,
    make_dataset,
    Partitioner,
    DataLoader,
    BatchKey,
)

__all__ = ["Dataset", "make_dataset", "Partitioner", "DataLoader", "BatchKey"]

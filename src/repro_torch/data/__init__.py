from repro_torch.data.partition import (
    PartitionConfig,
    assign_primary_labels,
    partition_dataset,
    Partition,
)
from repro_torch.data.synthetic import (
    SyntheticVisionDataset,
    SyntheticTextDataset,
    make_synthetic_vision,
    make_synthetic_text,
)
from repro_torch.data.pipeline import BatchIterator, PublicPool, client_stream_seed

__all__ = [
    "PartitionConfig",
    "assign_primary_labels",
    "partition_dataset",
    "Partition",
    "SyntheticVisionDataset",
    "SyntheticTextDataset",
    "make_synthetic_vision",
    "make_synthetic_text",
    "BatchIterator",
    "PublicPool",
    "client_stream_seed",
]

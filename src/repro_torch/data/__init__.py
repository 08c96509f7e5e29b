from repro_torch.data.partition import dirichlet_partition, iid_partition, split_public_private
from repro_torch.data.pipeline import batch_iterator, epoch_batches
from repro_torch.data.synthetic import IntentDataset, make_banking77_like, make_fed_benchmark_dataset, make_lm_stream

__all__ = [
    "dirichlet_partition",
    "iid_partition",
    "split_public_private",
    "batch_iterator",
    "epoch_batches",
    "IntentDataset",
    "make_banking77_like",
    "make_fed_benchmark_dataset",
    "make_lm_stream",
]

from repro_torch.data.pipeline import (Cifar10Like, ShardedDataset,  # noqa: F401
                                       lm_batch_keys, make_batch)

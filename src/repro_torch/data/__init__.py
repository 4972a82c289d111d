from repro_torch.data.pipeline import (ShardedDataset, lm_batch_keys,  # noqa: F401
                                       make_batch)

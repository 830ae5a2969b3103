from .user_blob import UserBlob, load_user_blob  # noqa: F401
from .dataset import ArraysDataset, BaseDataset, scrub_empty_clients  # noqa: F401
from .batching import (IndexRoundBatch, RoundBatch,  # noqa: F401
                       build_sample_pool, pack_eval_batches,
                       pack_round_batches, pack_round_indices,
                       seq_length_bucket, steps_for)
from .samplers import BatchSampler, DynamicBatchSampler  # noqa: F401

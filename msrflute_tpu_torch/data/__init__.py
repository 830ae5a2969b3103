from .user_blob import UserBlob, load_user_blob  # noqa: F401
from .dataset import ArraysDataset, BaseDataset, scrub_empty_clients  # noqa: F401
from .batching import (RoundBatch, pack_eval_batches,  # noqa: F401
                       pack_round_batches, steps_for)

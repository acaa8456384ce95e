from .cambridge import CAMBRIDGE_FEATURES, cambridge_data
from .sharding import shard_rows, train_eval_split, unshard_rows

__all__ = [
    "cambridge_data",
    "CAMBRIDGE_FEATURES",
    "shard_rows",
    "unshard_rows",
    "train_eval_split",
]

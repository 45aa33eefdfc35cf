from .synthetic import (
    SequentialBatches,
    SyntheticEpisodicDataset,
    make_episode,
    make_episode_batch,
)

__all__ = [
    "SequentialBatches",
    "SyntheticEpisodicDataset",
    "make_episode",
    "make_episode_batch",
]

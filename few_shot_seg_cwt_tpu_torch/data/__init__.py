from .classes import (
    CLASS_NAMES,
    NAME_TO_ID,
    filter_classes,
    get_split_classes,
    resolve_train_classes,
    resolve_val_classes,
)
from .episodic import EpisodicDataset, StandardDataset, binarize
from .listing import make_dataset
from .loader import EpisodeLoader, collate, infinite
from .replay import ReplayEpisodicDataset, load_episode_log
from .synthetic import (
    SequentialBatches,
    SyntheticEpisodicDataset,
    make_episode,
    make_episode_batch,
)
from . import transforms

__all__ = [
    "CLASS_NAMES",
    "NAME_TO_ID",
    "filter_classes",
    "get_split_classes",
    "resolve_train_classes",
    "resolve_val_classes",
    "EpisodicDataset",
    "StandardDataset",
    "binarize",
    "make_dataset",
    "EpisodeLoader",
    "collate",
    "infinite",
    "ReplayEpisodicDataset",
    "load_episode_log",
    "SequentialBatches",
    "SyntheticEpisodicDataset",
    "make_episode",
    "make_episode_batch",
    "transforms",
]

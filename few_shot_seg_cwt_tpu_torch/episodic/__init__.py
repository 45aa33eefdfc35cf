from .inner_loop import adapt_classifier, adapt_classifier_batch
from .engine import EpisodicEngine
from .heads import HeadEngine

__all__ = ["adapt_classifier", "adapt_classifier_batch", "EpisodicEngine", "HeadEngine"]

from .inner_loop import adapt_classifier, adapt_classifier_batch
from .engine import EpisodicEngine

__all__ = ["adapt_classifier", "adapt_classifier_batch", "EpisodicEngine"]

from .validate import validate_transformer

__all__ = ["validate_transformer"]

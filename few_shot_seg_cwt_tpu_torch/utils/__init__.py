from .meters import AverageMeter, CompareMeter

__all__ = ["AverageMeter", "CompareMeter"]

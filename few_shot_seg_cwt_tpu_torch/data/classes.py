"""Class-fold bookkeeping for PASCAL-5i and COCO-20i.

The port's own copy of ``few_shot_seg_cwt_tpu.data.classes`` (reference:
src/dataset/classes.py:119-199): PASCAL-5i has 4 folds of 5 validation
classes; COCO-20i uses either interleaved folds (``use_split_coco``,
range(i+1, 78+i, 4)) or contiguous 20-class blocks; cross-domain evaluation
filters test classes whose *name* was seen during training.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

# public class-id -> name tables (PASCAL VOC-20, COCO-80)
CLASS_NAMES: Dict[str, Dict[int, str]] = {
    "pascal": {
        # NOTE 7:cat / 8:car matches the REFERENCE's table (classes.py:94-96),
        # not official VOC ordering (7:car, 8:cat). The cross-domain name
        # filter compares names from this table on both sides, so parity
        # requires keeping the reference's ordering verbatim.
        1: "airplane", 2: "bicycle", 3: "bird", 4: "boat", 5: "bottle",
        6: "bus", 7: "cat", 8: "car", 9: "chair", 10: "cow",
        11: "diningtable", 12: "dog", 13: "horse", 14: "motorcycle",
        15: "person", 16: "pottedplant", 17: "sheep", 18: "sofa",
        19: "train", 20: "tv",
    },
    "coco": {
        1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
        6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
        11: "fire hydrant", 12: "stop sign", 13: "parking meter", 14: "bench",
        15: "bird", 16: "cat", 17: "dog", 18: "horse", 19: "sheep", 20: "cow",
        21: "elephant", 22: "bear", 23: "zebra", 24: "giraffe", 25: "backpack",
        26: "umbrella", 27: "handbag", 28: "tie", 29: "suitcase", 30: "frisbee",
        31: "skis", 32: "snowboard", 33: "sports ball", 34: "kite",
        35: "baseball bat", 36: "baseball glove", 37: "skateboard",
        38: "surfboard", 39: "tennis racket", 40: "bottle", 41: "wine glass",
        42: "cup", 43: "fork", 44: "knife", 45: "spoon", 46: "bowl",
        47: "banana", 48: "apple", 49: "sandwich", 50: "orange",
        51: "broccoli", 52: "carrot", 53: "hot dog", 54: "pizza", 55: "donut",
        56: "cake", 57: "chair", 58: "sofa", 59: "pottedplant", 60: "bed",
        61: "diningtable", 62: "toilet", 63: "tv", 64: "laptop", 65: "mouse",
        66: "remote", 67: "keyboard", 68: "cell phone", 69: "microwave",
        70: "oven", 71: "toaster", 72: "sink", 73: "refrigerator", 74: "book",
        75: "clock", 76: "vase", 77: "scissors", 78: "teddy bear",
        79: "hair drier", 80: "toothbrush",
    },
}

NAME_TO_ID: Dict[str, Dict[str, int]] = {
    ds: {name: cid for cid, name in table.items()} for ds, table in CLASS_NAMES.items()
}


def get_split_classes(use_split_coco: bool = False) -> Dict[str, Dict[int, Dict[str, List[int]]]]:
    """All train/val class lists for every fold of both datasets.

    ``split_classes['pascal'][0]['train']`` etc.; fold -1 holds all classes
    under 'val' (cross-domain target).
    """
    splits: Dict[str, Dict[int, Dict[str, List[int]]]] = {
        "coco": defaultdict(dict),
        "pascal": defaultdict(dict),
    }

    coco_all = list(range(1, 81))
    splits["coco"][-1]["val"] = coco_all
    if use_split_coco:
        folds = [list(range(1 + i, 78 + i, 4)) for i in range(4)]
    else:
        folds = [list(range(1 + 20 * i, 21 + 20 * i)) for i in range(4)]
    for i, val in enumerate(folds):
        splits["coco"][i]["val"] = val
        splits["coco"][i]["train"] = sorted(set(coco_all) - set(val))

    pascal_all = list(range(1, 21))
    splits["pascal"][-1]["val"] = pascal_all
    for i in range(4):
        val = list(range(1 + 5 * i, 6 + 5 * i))
        splits["pascal"][i]["val"] = val
        splits["pascal"][i]["train"] = sorted(set(pascal_all) - set(val))

    return splits


def filter_classes(
    train_name: str,
    train_split: int,
    test_name: str,
    test_split: int,
    split_classes: Dict,
    verbose: bool = False,
) -> List[int]:
    """Drop test classes whose *name* appeared in the training fold.

    Identity mapping for same-dataset eval; meaningful for coco2pascal /
    pascal2coco transfer (reference: src/dataset/classes.py:164-199).
    """
    seen = {
        CLASS_NAMES[train_name][c]
        for c in split_classes[train_name][train_split]["train"]
    }
    kept, removed = [], []
    for c in split_classes[test_name][test_split]["val"]:
        if CLASS_NAMES[test_name][c] in seen:
            removed.append(CLASS_NAMES[test_name][c])
        else:
            kept.append(c)
    if verbose:
        print(f">> Removed classes = {removed}")
        print(f">> Kept classes = {[CLASS_NAMES[test_name][c] for c in kept]}")
    return kept


def resolve_val_classes(cfg) -> List[int]:
    """Validation class list for a config (reference: src/dataset/dataset.py:86-95)."""
    splits = get_split_classes(cfg.use_split_coco)
    if cfg.test_name == "default":
        test_name, test_split = cfg.train_name, cfg.train_split
    else:
        test_name, test_split = cfg.test_name, cfg.test_split
    return filter_classes(cfg.train_name, cfg.train_split, test_name, test_split, splits)


def resolve_train_classes(cfg) -> List[int]:
    splits = get_split_classes(cfg.use_split_coco)
    return splits[cfg.train_name][cfg.train_split]["train"]

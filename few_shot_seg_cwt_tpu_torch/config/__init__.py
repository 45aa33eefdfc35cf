from .config import (
    Cfg,
    default_cfg,
    load_cfg,
    load_cfg_from_cfg_file,
    merge_cfg_from_list,
    parse_args,
)

__all__ = [
    "Cfg",
    "default_cfg",
    "load_cfg",
    "load_cfg_from_cfg_file",
    "merge_cfg_from_list",
    "parse_args",
]

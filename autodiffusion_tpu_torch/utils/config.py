"""Defaults-dict argparse generation (script_util.py:456-481 semantics).

The reference builds its CLIs from flat defaults dicts with types inferred
from default values and a str2bool for flags; kept here so every published
``--flag value`` combination from the reference's .sh files parses
unchanged.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

__all__ = ["add_dict_to_argparser", "args_to_dict", "str2bool"]


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def add_dict_to_argparser(parser: argparse.ArgumentParser,
                          default_dict: Dict[str, Any]) -> None:
    for k, v in default_dict.items():
        v_type = type(v)
        if v is None:
            v_type = str
        elif isinstance(v, bool):
            v_type = str2bool
        parser.add_argument(f"--{k}", default=v, type=v_type)


def args_to_dict(args: argparse.Namespace, keys) -> Dict[str, Any]:
    """{key: args.key} for each of ``keys``."""
    return {k: getattr(args, k) for k in keys}

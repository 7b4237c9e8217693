"""Experiment log: lines to stdout and to ``log.txt``.

The part of the OpenAI-baselines logger surface (guided_diffusion/
logger.py:36-267) that the search path uses: ``configure`` and ``log``.
Search results are *delivered via the log* (the user greps the "top k"
tables, gd/README.md:24), so the line formats are kept greppable and
stable. The key-value outputs (csv, json, tensorboard) wait for the
training slice.
"""

from __future__ import annotations

import datetime
import os
import os.path as osp
import sys
import tempfile
from typing import Optional, TextIO

__all__ = ["configure", "log"]


class Logger:
    CURRENT: "Optional[Logger]" = None

    def __init__(self, dir: Optional[str], log_to_stdout: bool = True):
        self.dir = dir
        self.log_to_stdout = log_to_stdout
        self.file: Optional[TextIO] = None
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self.file = open(osp.join(dir, "log.txt"), "at")

    def log(self, *args) -> None:
        line = " ".join(map(str, args)) + "\n"
        # sys.stdout is looked up per line, so a replaced stream (a test's
        # capture) is honoured
        for f in ([sys.stdout] if self.log_to_stdout else []) + \
                ([self.file] if self.file is not None else []):
            f.write(line)
            f.flush()

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None


def configure(dir: Optional[str] = None, log_to_stdout: bool = True) -> Logger:
    """Log to stdout and ``dir/log.txt``; ``dir`` defaults to $ADT_LOGDIR or
    a fresh directory under the system's temporary directory."""
    if dir is None:
        dir = os.environ.get("ADT_LOGDIR")
    if dir is None:
        dir = osp.join(tempfile.gettempdir(), "adt-" +
                       datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S-%f"))
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir, log_to_stdout)
    log(f"Logging to {dir}")
    return Logger.CURRENT


def log(*args) -> None:
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(None)
    Logger.CURRENT.log(*args)

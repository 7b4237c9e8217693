"""Experiment logger: stdout table, log.txt, progress.csv, JSON lines.

Port of autodiffusion_tpu/utils/logger.py, the OpenAI-baselines logger
surface the reference uses (guided_diffusion/logger.py:36-267): module-level
``log``, ``logkv``, ``logkv_mean``, ``dumpkvs``, ``configure`` and
``get_dir``. Search results are *delivered via the log* (the user
greps the "top k" tables, gd/README.md:24), so the formats are kept
greppable and stable, and equal to the JAX package's line for line.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import os.path as osp
import sys
import tempfile
from collections import defaultdict
from typing import Any, Dict, List, Optional, TextIO

__all__ = ["configure", "log", "logkv", "logkv_mean", "dumpkvs", "get_dir"]


class HumanOutput:
    """Key-value tables and log lines as text. ``file`` None writes to
    ``sys.stdout``, looked up per write, so a replaced stream (a test's
    capture) is honoured."""

    def __init__(self, file: Optional[TextIO]):
        self.file = file

    def _out(self) -> TextIO:
        return sys.stdout if self.file is None else self.file

    def writekvs(self, kvs: Dict[str, Any]) -> None:
        key2str = {}
        for k, v in sorted(kvs.items()):
            s = f"{v:<8.3g}" if hasattr(v, "__float__") else str(v)
            key2str[self._trunc(k)] = self._trunc(s)
        if not key2str:
            return
        kw = max(map(len, key2str.keys()))
        vw = max(map(len, key2str.values()))
        dashes = "-" * (kw + vw + 7)
        lines = [dashes]
        for k, v in sorted(key2str.items()):
            lines.append(f"| {k}{' ' * (kw - len(k))} | {v}{' ' * (vw - len(v))} |")
        lines.append(dashes)
        out = self._out()
        out.write("\n".join(lines) + "\n")
        out.flush()

    @staticmethod
    def _trunc(s: str, maxlen: int = 30) -> str:
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s

    def writeseq(self, seq) -> None:
        out = self._out()
        out.write(" ".join(map(str, seq)) + "\n")
        out.flush()

    def close(self) -> None:
        if self.file is not None:
            self.file.close()


class JSONOutput:
    def __init__(self, filename: str):
        self.file = open(filename, "at")

    def writekvs(self, kvs) -> None:
        out = {k: float(v) if hasattr(v, "__float__") else v
               for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class CSVOutput:
    def __init__(self, filename: str):
        self.filename = filename
        self.keys: List[str] = []

    def writekvs(self, kvs) -> None:
        extra = sorted(k for k in kvs if k not in self.keys)
        if extra:
            self.keys += extra
            rows = []
            if osp.exists(self.filename):
                with open(self.filename) as f:
                    rows = list(csv.DictReader(f))
                # a resumed run's progress.csv may carry columns this run
                # never logs; keep them so DictWriter does not raise
                for r in rows:
                    for k in r:
                        if k not in self.keys:
                            self.keys.append(k)
            with open(self.filename, "wt", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self.keys)
                w.writeheader()
                for r in rows:
                    w.writerow(r)
        with open(self.filename, "at", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.keys)
            w.writerow({k: kvs.get(k, "") for k in self.keys})


class TensorBoardOutput:
    """Scalar summaries via torch.utils.tensorboard (the reference's
    optional TensorBoard writer, logger.py:152-189). The Logger skips it
    where tensorboard cannot be imported."""

    def __init__(self, dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(dir)
        self._auto_step = 0

    def writekvs(self, kvs) -> None:
        step = int(kvs.get("step", self._auto_step))
        for k, v in kvs.items():
            if k == "step":
                continue
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass
        self.writer.flush()
        self._auto_step += 1

    def close(self) -> None:
        self.writer.close()


class Logger:
    CURRENT: "Optional[Logger]" = None

    def __init__(self, dir: Optional[str], log_to_stdout: bool = True,
                 formats: Optional[List[str]] = None):
        self.dir = dir
        self.name2val: Dict[str, Any] = defaultdict(float)
        self.name2cnt: Dict[str, int] = defaultdict(int)
        self.outputs: List[Any] = []
        if formats is None:
            formats = os.environ.get(
                "ADT_LOG_FORMAT", "stdout,log,csv,json").split(",")
        self.text_outputs: List[Any] = \
            [HumanOutput(None)] if (log_to_stdout and "stdout" in formats) \
            else []
        if dir is not None and set(formats) - {"stdout"}:
            os.makedirs(dir, exist_ok=True)
            if "log" in formats:
                self.text_outputs.append(
                    HumanOutput(open(osp.join(dir, "log.txt"), "at")))
            if "csv" in formats:
                self.outputs.append(CSVOutput(osp.join(dir, "progress.csv")))
            if "json" in formats:
                self.outputs.append(JSONOutput(osp.join(dir,
                                                        "progress.json")))
            if "tensorboard" in formats:
                try:
                    self.outputs.append(
                        TensorBoardOutput(osp.join(dir, "tb")))
                except ImportError:
                    self.log("tensorboard requested but not installed; "
                             "skipping")

    def log(self, *args) -> None:
        for o in self.text_outputs:
            o.writeseq(args)

    def logkv(self, key, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key, val) -> None:
        old, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = old * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> Dict[str, Any]:
        d = dict(self.name2val)
        for o in self.text_outputs + self.outputs:
            o.writekvs(d)
        self.name2val.clear()
        self.name2cnt.clear()
        return d

    def close(self) -> None:
        for o in self.text_outputs + self.outputs:
            if hasattr(o, "close"):
                o.close()
        self.text_outputs, self.outputs = [], []


def configure(dir: Optional[str] = None, log_to_stdout: bool = True,
              formats: Optional[List[str]] = None) -> Logger:
    """Log to ``dir`` (log.txt, progress.csv, progress.json) and stdout.
    ``dir`` defaults to $ADT_LOGDIR or a fresh directory under the system's
    temporary directory; formats, a subset of {stdout, log, csv, json,
    tensorboard}, to $ADT_LOG_FORMAT or 'stdout,log,csv,json'."""
    if dir is None:
        dir = os.environ.get("ADT_LOGDIR")
    if dir is None:
        dir = osp.join(tempfile.gettempdir(), "adt-" +
                       datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S-%f"))
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir, log_to_stdout, formats=formats)
    log(f"Logging to {dir}")
    return Logger.CURRENT


def _current() -> Logger:
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(None)
    return Logger.CURRENT


def log(*args) -> None:
    _current().log(*args)


def logkv(key, val) -> None:
    _current().logkv(key, val)


def logkv_mean(key, val) -> None:
    _current().logkv_mean(key, val)


def dumpkvs() -> Dict[str, Any]:
    return _current().dumpkvs()


def get_dir() -> Optional[str]:
    return _current().dir

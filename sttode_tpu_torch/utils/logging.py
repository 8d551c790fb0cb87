"""Logging (port of ``sttode_tpu/utils/logging.py``: the reference's
``print_log`` line and a file ``Logger``)."""

from __future__ import annotations

import os
import sys
import time


class Logger:
    """Tee messages to stdout and an optional log file with timestamps."""

    def __init__(self, log_path: str | None = None, also_stdout: bool = True):
        self.also_stdout = also_stdout
        self.fh = None
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                        exist_ok=True)
            self.fh = open(log_path, "a")

    def log(self, msg: str):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        if self.also_stdout:
            print(line)
            sys.stdout.flush()
        if self.fh:
            self.fh.write(line + "\n")
            self.fh.flush()

    __call__ = log

    def close(self):
        if self.fh:
            self.fh.close()
            self.fh = None


def print_log(dataset: str, epoch: int, total_epochs: int, it: int,
              total_its: int, loss_str: str, log: Logger | None = None):
    """Iteration-cadence training line (the reference's print_log format)."""
    msg = (f"{dataset} | Epo: {epoch:02d}/{total_epochs:02d}, "
           f"It: {it:04d}/{total_its:04d}, {loss_str}")
    (log or Logger())(msg)

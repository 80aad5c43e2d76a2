"""Wall-clock timing helpers (the reference's only observability was a
per-recording Timer, predict.py:27-40; this one also feeds structured run
logs)."""

from __future__ import annotations

import logging
import time

logger = logging.getLogger("vbx_tpu_torch")


class Timer:
    def __init__(self, name: str = "", log: bool = True):
        self.name = name
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        self.tstart = time.perf_counter()
        if self.log and self.name:
            logger.info("Start: %s", self.name)
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.tstart
        if self.log and self.name:
            logger.info("End: %s: elapsed %.3fs", self.name, self.elapsed)
        return False

"""Structured per-recording run logging (SURVEY.md §5: the reference's only
observability is a wall-clock Timer and bare prints; this framework records
one JSON object per recording — iterations, ELBO trace, surviving speakers,
stage timings — plus a corpus-level summary)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, IO, Optional

import numpy as np


class RunLog:
    """Append-only JSONL log; safe to pass None-path (no-op)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fd: Optional[IO[str]] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fd = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        if self._fd is None:
            return
        record = dict(record, ts=time.time())
        self._fd.write(json.dumps(record, default=_jsonable) + "\n")
        self._fd.flush()

    def recording(self, name: str, *, n_speakers: int, n_iters: int,
                  elbo=None, seconds: Optional[float] = None,
                  **extra) -> None:
        rec = {"event": "recording", "name": name,
               "n_speakers": n_speakers, "n_iters": n_iters}
        if elbo is not None:
            e = np.asarray(elbo, float)
            e = e[~np.isnan(e)]
            rec["elbo_first"] = float(e[0]) if e.size else None
            rec["elbo_last"] = float(e[-1]) if e.size else None
        if seconds is not None:
            rec["seconds"] = round(seconds, 4)
        rec.update(extra)
        self.write(rec)

    def close(self) -> None:
        if self._fd is not None:
            self._fd.close()
            self._fd = None


def _jsonable(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not jsonable: {type(o)}")

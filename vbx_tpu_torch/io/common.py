"""Shared helpers for the io codecs."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def open_sink(path_or_fd, mode: str = "w"):
    """Yield a writable file object: file-likes pass through (left open for
    the caller), paths are opened in `mode` and closed on exit. The single
    write dispatch for every codec writer (rttm/segments/ark/uem)."""
    if hasattr(path_or_fd, "write"):
        yield path_or_fd
    else:
        with open(path_or_fd, mode) as fp:
            yield fp

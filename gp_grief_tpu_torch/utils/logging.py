"""Structured observability: per-step metric records to stdout and/or JSONL.

Counterpart of ``gp_grief_tpu.utils.logging``: metrics are emitted as
structured dicts, one JSON object per line, so benches and CI scripts parse
them directly.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    """Append-only JSONL metric stream with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.perf_counter()

    def log(self, **metrics) -> None:
        rec = {"t": round(time.perf_counter() - self._t0, 6), **metrics}
        line = json.dumps(rec)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

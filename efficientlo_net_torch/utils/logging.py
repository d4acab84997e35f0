"""File and stdout tee logger with a scalar journal.

The port's copy of ``efficientlo_net_tpu/utils/logging.py``: each message
goes to stdout and the log file; scalars go to ``<log>_scalars.jsonl``, one
JSON object per line.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class Logger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._scalars = open(os.path.splitext(path)[0] + "_scalars.jsonl", "a") if path else None

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def scalar(self, name: str, value: float, step: int) -> None:
        if self._scalars:
            self._scalars.write(json.dumps({"name": name, "value": float(value),
                                            "step": int(step), "ts": time.time()}) + "\n")
            self._scalars.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._scalars:
            self._scalars.close()

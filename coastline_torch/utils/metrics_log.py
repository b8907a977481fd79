"""Structured run logging (the port's copy of `coastline/utils/metrics_log.py`):
one JSON object a line, appended; no file without a path."""

import json
import os
import time
from typing import Optional


class JsonlLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, **record):
        if not self.path:
            return
        record.setdefault("t", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

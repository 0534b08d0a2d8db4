"""Metric logging (counterpart of nerf_mae_tpu/utils.py MetricLogger):
one JSON object {"step": ..., **metrics} per line in
<log_dir>/metrics_<run_name>.jsonl."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 run_name: Optional[str] = None):
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(
                log_dir, f"metrics_{run_name or int(time.time())}.jsonl")
            self._file = open(path, "a")
            logger.info("metric log: %s", path)

    def log(self, step: int, metrics: Dict[str, float]):
        if self._file:
            self._file.write(json.dumps({"step": step, **metrics}) + "\n")
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

"""Metric logging (counterpart of nerf_mae_tpu/utils.py MetricLogger):
one JSON object {"step": ..., **metrics} per line in
<log_dir>/metrics_<run_name>.jsonl, forwarded to wandb when --wandb asks
for it and the package can be imported (without it a warning is logged
and the jsonl stream goes on)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 project: str = "nerf-mae-torch", run_name: Optional[str] = None,
                 config: Optional[Dict] = None):
        self._file = None
        self._wandb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(
                log_dir, f"metrics_{run_name or int(time.time())}.jsonl")
            self._file = open(path, "a")
            logger.info("metric log: %s", path)
        if use_wandb:
            try:
                import wandb
            except ImportError:
                logger.warning("wandb requested but not installed; "
                               "logging to jsonl only")
            else:
                wandb.init(project=project, name=run_name, config=config or {})
                self._wandb = wandb

    def log(self, step: int, metrics: Dict[str, float]):
        if self._file:
            self._file.write(json.dumps({"step": step, **metrics}) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None

"""Experiment tracking: a copy of the JAX package's ``utils/logging.py``
(ROADMAP A.12). ``MetricLogger`` prints the reference driver's per-epoch
line, appends JSONL when given a path, and mirrors to Weights & Biases
when that package is importable and ``WANDB_MODE`` is not "disabled".
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, project: str = "MAG", config: Optional[Dict] = None,
                 jsonl_path: Optional[str] = None, use_wandb: bool = True,
                 stream=None):
        self.stream = stream or sys.stdout
        self.jsonl_path = jsonl_path
        self._wandb = None
        if use_wandb and os.environ.get("WANDB_MODE") != "disabled":
            try:
                import wandb  # type: ignore

                wandb.init(project=project)
                if config:
                    wandb.config.update(config)
                self._wandb = wandb
            except Exception:
                self._wandb = None
        self._t0 = time.monotonic()

    def log(self, record: Dict[str, Any]) -> None:
        rec = dict(record)
        rec.setdefault("wall_seconds", round(time.monotonic() - self._t0, 3))
        if "epoch" in rec:
            print(
                "epoch:{}, train_loss:{}, valid_loss:{}, test_acc:{}".format(
                    rec.get("epoch"), rec.get("train_loss"),
                    rec.get("valid_loss"), rec.get("test_acc")),
                file=self.stream)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(record)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()

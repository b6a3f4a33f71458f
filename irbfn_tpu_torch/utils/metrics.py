"""Metric logging for the trainers.

Port of ``irbfn_tpu/utils/profiling.py:MetricLogger``: per-batch losses go to
a local JSONL file (works offline); wandb is attached only if it can be
imported and the caller asks for it.
"""

from __future__ import annotations

import json
import os
from typing import Optional


class MetricLogger:
    """JSONL metric logging with optional wandb mirroring. Values with an
    ``item()`` (tensors, numpy scalars) become floats, which waits for the
    device: log every few steps, not every step."""

    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 project: str = "irbfn_tpu_torch",
                 config: Optional[dict] = None, tags=None):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        else:
            self._fh = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # noqa: PLC0415

                self._wandb = wandb
                wandb.init(project=project, config=config, tags=tags)
            except Exception:
                self._wandb = None

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                   else v) for k, v in metrics.items() if v is not None}
        if step is not None:
            rec["step"] = step
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(rec, step=step)

    def close(self):
        if self._fh:
            self._fh.close()

"""Metric logging: JSONL always, TensorBoard when available (a copy of
cofii2p_tpu/utils/metrics.py, which imports no JAX).

The reference logs scalars to TensorBoard + a text log
(the reference train.py:168-181, 294-297); this writer keeps that
capability without hard-depending on TensorBoard.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Mapping


class MetricWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass

    def write(self, step: int, scalars: Mapping[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def setup_logger(log_dir: str | None = None) -> logging.Logger:
    """Console + optional file logger (reference train.py:169-181)."""
    logger = logging.getLogger("cofii2p_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger

"""Logging + running-mean utilities (reference: utils.py:262-294) — the
counterpart of `amid_tpu/utils/logging.py`."""

from __future__ import annotations

import logging
from pathlib import Path

import torch.distributed as dist


class AverageMeter:
    """Running means keyed by metric name (utils.py:262-280)."""

    def __init__(self, *keys: str) -> None:
        self.totals = {k: 0.0 for k in keys}
        self.counts = {k: 0 for k in keys}

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            if k not in self.totals:
                self.totals[k] = 0.0
                self.counts[k] = 0
            self.totals[k] += float(v)
            self.counts[k] += 1

    def mean(self, key: str) -> float:
        c = self.counts.get(key, 0)
        return self.totals.get(key, 0.0) / c if c else 0.0

    def __getattr__(self, attr: str) -> float:
        if attr.startswith("_") or attr in ("totals", "counts"):
            raise AttributeError(attr)
        return self.mean(attr)


def init_logger(log_dir: str, log_file: str) -> logging.Logger:
    """Console + file logger (utils.py:282-294: model_dir/log{seed}.txt).

    In a `torch.distributed` world only rank 0 gets the file handler: every
    rank runs the same trainer, and N ranks appending to one model_dir file
    would interleave; the others keep the console."""
    logger = logging.getLogger("amid_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "[%(asctime)s] %(message)s", "%Y/%m/%d %H:%M:%S"
    )
    # reset handlers so per-seed files don't stack
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    logger.propagate = False
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return logger
    d = Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(str(d / log_file))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger

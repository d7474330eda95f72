"""Metric sinks with the JAX package's artifact contract (the
counterpart of ``recsys_tpu/utils/metrics_io.py``, which imports jax):

* ``training_log.csv``      — per-epoch scalars;
* ``detailed_metrics.json`` — per-epoch history (flushed every
  ``flush_every`` epochs and at close);
* ``metrics.json``          — the final offline-eval metrics;
* ``config.json``           — the run config.

Console + CSV + JSON only: the TensorBoard and W&B sinks are not ported.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

try:  # optional, as in the JAX package
    import psutil

    _PSUTIL = True
except ImportError:  # pragma: no cover
    _PSUTIL = False


class MetricWriter:
    """Collects per-epoch metrics and writes the artifact set."""

    def __init__(self, output_dir: str, flush_every: int = 2):
        self.output_dir = output_dir
        self.flush_every = flush_every
        self.history: List[Dict[str, Any]] = []
        self._csv_fields: Optional[List[str]] = None
        self._epoch_start = 0.0
        os.makedirs(output_dir, exist_ok=True)

    def start_epoch(self) -> None:
        self._epoch_start = time.time()

    def end_epoch(self, epoch: int, logs: Dict[str, float]) -> Dict[str, Any]:
        entry: Dict[str, Any] = {"epoch": epoch, **{k: float(v) for k, v in logs.items()}}
        entry["epoch_time_s"] = time.time() - self._epoch_start
        if _PSUTIL:
            p = psutil.Process()
            entry["memory_mb"] = p.memory_info().rss / 1e6
            entry["cpu_percent"] = p.cpu_percent()
        self.history.append(entry)
        self._write_csv_row(entry)
        if (epoch + 1) % self.flush_every == 0:
            self._flush_detailed()
        logger.info("epoch %d: %s", epoch,
                    " ".join(f"{k}={v:.4f}" for k, v in entry.items() if k != "epoch"))
        return entry

    def _write_csv_row(self, entry: Dict[str, Any]) -> None:
        path = os.path.join(self.output_dir, "training_log.csv")
        if self._csv_fields is None:
            self._csv_fields = list(entry.keys())
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._csv_fields).writeheader()
        with open(path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._csv_fields,
                           extrasaction="ignore").writerow(entry)

    def _flush_detailed(self) -> None:
        with open(os.path.join(self.output_dir, "detailed_metrics.json"), "w") as f:
            json.dump({"epochs": self.history}, f, indent=2)

    def write_final_metrics(self, metrics: Dict[str, float]) -> None:
        with open(os.path.join(self.output_dir, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)

    def write_config(self, config) -> None:
        config.save(os.path.join(self.output_dir, "config.json"))

    def close(self) -> None:
        self._flush_detailed()


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(level=level,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
                        force=True)

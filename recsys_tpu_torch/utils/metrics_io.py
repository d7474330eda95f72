"""Metric sinks with the JAX package's artifact contract (the
counterpart of ``recsys_tpu/utils/metrics_io.py``, which imports jax):

* ``training_log.csv``      — per-epoch scalars;
* ``detailed_metrics.json`` — per-epoch history (flushed every
  ``flush_every`` epochs and at close);
* ``metrics.json``          — the final offline-eval metrics;
* ``config.json``           — the run config.

Sinks: console, CSV and JSON always; TensorBoard (tensorboardX event files
under ``<output_dir>/tensorboard``, a scalar per key a epoch) and W&B
(per-epoch ``log`` to the active run, which ``--use_wandb`` starts, and
``final/<k>``) when the libraries import, imported lazily as in the JAX
package. Under a process group of several ranks only rank 0 writes (every
rank keeps the history), and log lines carry ``[host r] ``.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

from recsys_tpu_torch.parallel.mesh import process_count, process_index

logger = logging.getLogger(__name__)

try:  # optional, as in the JAX package
    import psutil

    _PSUTIL = True
except ImportError:  # pragma: no cover
    _PSUTIL = False


class MetricWriter:
    """Collects per-epoch metrics and writes the artifact set."""

    def __init__(self, output_dir: str, flush_every: int = 2, tensorboard: bool = True):
        self.output_dir = output_dir
        self.flush_every = flush_every
        self.history: List[Dict[str, Any]] = []
        self._csv_fields: Optional[List[str]] = None
        self._epoch_start = 0.0
        self._is_writer = process_index() == 0
        self._tb = None
        if self._is_writer:
            os.makedirs(output_dir, exist_ok=True)
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(os.path.join(output_dir, "tensorboard"))
                except ImportError:
                    logger.info("tensorboardX not installed; TB sink off")

    @staticmethod
    def _wandb_run():
        """The active W&B run, if ``--use_wandb`` started one (``wandb.run``
        is the library's own process-global)."""
        wandb = sys.modules.get("wandb")
        return getattr(wandb, "run", None) if wandb is not None else None

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
        if self._is_writer:
            self._write_csv_row(entry)
            if self._tb is not None:
                for k, v in entry.items():
                    if k != "epoch":
                        self._tb.add_scalar(k, v, global_step=epoch)
            run = self._wandb_run()
            if run is not None:
                run.log({k: v for k, v in entry.items() if k != "epoch"}, step=epoch)
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
        if self._is_writer:
            with open(os.path.join(self.output_dir, "metrics.json"), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)
            run = self._wandb_run()
            if run is not None:
                run.log({f"final/{k}": float(v) for k, v in metrics.items()
                         if isinstance(v, (int, float))})

    def write_config(self, config) -> None:
        if self._is_writer:
            config.save(os.path.join(self.output_dir, "config.json"))

    def close(self) -> None:
        if self._is_writer:
            self._flush_detailed()
            if self._tb is not None:
                self._tb.close()
                self._tb = None


def setup_logging(level: int = logging.INFO) -> None:
    """The log format, with ``[host r] `` under a group of several ranks
    (call it after the process joined its group)."""
    prefix = f"[host {process_index()}] " if process_count() > 1 else ""
    logging.basicConfig(level=level,
                        format=f"%(asctime)s {prefix}%(name)s %(levelname)s: %(message)s",
                        force=True)

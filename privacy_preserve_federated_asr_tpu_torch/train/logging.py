"""Metric sinks: JSON-lines file logging + in-memory history.

Format-compatible with the reference's ``CustomTrainer.log`` JSON-line files
(federated/src/update.py:77-98: one ``json.dumps`` of the metrics dict per
line, appended to ``./saves/log/<name>.txt``) so existing log-parsing
analysis notebooks keep working. A CSV scalar sink stands in for the
tensorboardX re-emission (update.py:398-411).

A copy of ``privacy_preserve_federated_asr_tpu/train/logging.py`` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any


class JsonlLogger:
    def __init__(self, log_dir: str | os.PathLike = "./saves/log",
                 filename: str | None = None, echo: bool = True):
        self.history: list[dict[str, Any]] = []
        self.echo = echo
        self.path = None
        if filename is not None:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self.path = Path(log_dir) / filename

    def log(self, metrics: dict[str, Any]) -> None:
        record = {k: _pyval(v) for k, v in metrics.items()}
        self.history.append(record)
        line = json.dumps(record)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)

    def dump_scalars_csv(self, path: str) -> None:
        """All history rows as CSV (tensorboard-scalar stand-in)."""
        keys = sorted({k for r in self.history for k in r})
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self.history:
                f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")


def record_result(history: list[dict[str, Any]], result_folder: str,
                  logs_root: str = "./logs") -> str | None:
    """Re-emit the run's history as TensorBoard scalars — the reference's
    third metric sink (``record_result``, federated/src/update.py:398-411):
    Loss/train from "loss" rows, Loss/test + wer/test from "eval_loss" rows,
    Loss/train from the final "train_loss" row, all at step ``epoch*100``.

    Uses torch's bundled SummaryWriter (tensorboardX twin); returns the event
    dir, or None when no TB writer is importable (sink degrades to the
    JSON-lines + CSV sinks, which always run).
    """
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None

    out_dir = os.path.join(logs_root, os.path.basename(str(result_folder).rstrip("/")))
    w = SummaryWriter(out_dir)
    for row in history:
        step = int(float(row.get("epoch", 0.0)) * 100)
        if "loss" in row:
            w.add_scalar("Loss/train", float(row["loss"]), step)
        elif "eval_loss" in row:
            w.add_scalar("Loss/test", float(row["eval_loss"]), step)
            if "eval_wer" in row:
                w.add_scalar("wer/test", float(row["eval_wer"]), step)
        elif "train_loss" in row:
            w.add_scalar("Loss/train", float(row["train_loss"]), step)
    w.close()
    return out_dir


def _pyval(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class StepTimer:
    """Wall-clock per-step timing for throughput reporting (the reference
    relies on HF's train_runtime/train_samples_per_second summary rows)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.samples = 0
        self.steps = 0

    def update(self, batch_size: int) -> None:
        self.samples += batch_size
        self.steps += 1

    def summary(self) -> dict[str, float]:
        dt = time.perf_counter() - self.t0
        return {
            "train_runtime": dt,
            "train_samples_per_second": self.samples / dt if dt > 0 else 0.0,
            "train_steps_per_second": self.steps / dt if dt > 0 else 0.0,
        }

"""Metric recording: TensorBoard + TSV (own copy of the JAX package's
``utils/recorder.py``): per-iteration scalars under
``Train_iter_loss/state{k}/{key}``, per-epoch means under
``Train_epoch_loss/state{k}/{key}``, the run dir named by timestamp +
scenario or by the description. Writes the TSV alone when TensorBoard
does not import.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Optional


class Recorder:
    def __init__(
        self,
        log_root: str = "runs",
        scenario_tag: str = "",
        description: str = "None",
        enabled: bool = True,
    ):
        self.enabled = enabled
        if description != "None":
            run_name = description
        else:
            run_name = time.strftime("%b%d_%H-%M-%S") + "_" + scenario_tag
        self.log_dir = os.path.join(log_root, run_name)
        self._writer = None
        if enabled:
            os.makedirs(self.log_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir=self.log_dir)
            except ImportError:
                self._writer = None
            self._tsv = open(os.path.join(self.log_dir, "metrics.tsv"), "a")
        self._epoch_acc: Dict[str, list] = defaultdict(list)
        self.iter_count = 0

    # ------------------------------------------------------------------
    def add_iter_loss(self, state: int, losses: Dict[str, float]) -> None:
        if not self.enabled:
            return
        self.iter_count += 1
        for key, value in losses.items():
            value = float(value)
            self._epoch_acc[key].append(value)
            if self._writer:
                self._writer.add_scalar(
                    f"Train_iter_loss/state{state}/{key}", value, self.iter_count
                )
        self._tsv.write(
            f"iter\t{self.iter_count}\t" +
            "\t".join(f"{k}={float(v):.6f}" for k, v in losses.items()) + "\n"
        )

    def end_epoch(self, state: int, epoch: int) -> Dict[str, float]:
        means = {
            k: sum(v) / max(len(v), 1) for k, v in self._epoch_acc.items()
        }
        if self.enabled:
            for key, value in means.items():
                if self._writer:
                    self._writer.add_scalar(
                        f"Train_epoch_loss/state{state}/{key}", value, epoch
                    )
            self._tsv.write(
                f"epoch\t{epoch}\t" +
                "\t".join(f"{k}={v:.6f}" for k, v in means.items()) + "\n"
            )
            self._tsv.flush()
        self._epoch_acc.clear()
        return means

    def next_state(self) -> None:
        """State rollover: reset the per-epoch accumulators."""
        self._epoch_acc.clear()

    def add_hparams(self, hparams: Dict, metrics: Dict[str, float]) -> None:
        clean = {
            k: (v if isinstance(v, (int, float, str, bool)) else str(v))
            for k, v in hparams.items()
        }
        if self._writer:
            self._writer.add_hparams(clean, metrics)
        elif self.enabled:
            # TSV fallback (no tensorboard import): keep the summary
            for k, v in {**clean, **metrics}.items():
                self._tsv.write(f"hparams\t{k}\t{v}\n")
            self._tsv.flush()

    def close(self) -> None:
        if self._writer:
            self._writer.close()
        if self.enabled:
            self._tsv.close()

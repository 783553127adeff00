"""Console + JSONL metric logging, a copy of the framework-free
``acmil_tpu/utils/logging.py``.

Reference: `utils/utils.py:74-216` (`SmoothedValue`, `MetricLogger` with
windowed meters, iter/data timing, ETA, device-memory print) and
`Wandb_Writer` (`utils/utils.py:486-495`). :class:`MetricsWriter` speaks
the same ``log(dict, commit)`` protocol and always writes JSONL; when wandb
is importable and a mode other than ``disabled`` is asked for, it logs to
wandb as well.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np


class SmoothedValue:
    """Windowed + global average meter (`utils/utils.py:74-...`)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __getattr__(self, name):
        meters = object.__getattribute__(self, "meters")
        if name in meters:
            return meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        """Yield items while printing smoothed stats, iter/data time and
        ETA every ``print_freq`` iterations (`utils/utils.py:172-216`)."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_s = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i}/{total}] eta: {eta_s} {self} "
                          f"time: {iter_time} data: {data_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}", flush=True)
            i += 1
            end = time.time()
        total_time = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}",
              flush=True)


class MetricsWriter:
    """wandb-compatible writer: uses wandb when importable+enabled, else
    appends JSONL under ``log_dir`` (`Wandb_Writer`, utils/utils.py:486).
    With ``enabled`` False (every rank of a mesh but global rank 0) it
    writes nothing."""

    def __init__(self, project: str = "wsi_classification", mode: str = "disabled",
                 log_dir: str = "./logs", config: Optional[dict] = None,
                 group: str = "", enabled: bool = True):
        self.mode = mode
        self._wandb = None
        self._pending: dict = {}
        self._step = 0
        self._fh = None
        if not enabled:
            return
        if mode != "disabled":
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, config=config or {}, mode=mode,
                           group=group or None)
            except ImportError:
                self._wandb = None
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        if config:
            self._fh.write(json.dumps({"_config": config}, default=str) + "\n")

    @property
    def run_dir(self) -> str:
        if self._wandb is not None and self._wandb.run is not None:
            return self._wandb.run.dir
        return os.path.dirname(self.path)

    def log(self, metrics: dict, commit: bool = True, step: Optional[int] = None):
        if self._fh is None:
            return
        if self._wandb is not None:
            self._wandb.log(metrics, commit=commit, step=step)
        self._pending.update({k: float(v) for k, v in metrics.items()})
        if commit:
            rec = {"step": self._step if step is None else step}
            rec.update(self._pending)
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            self._pending = {}
            self._step += 1

    def summary(self, key: str, value):
        self.log({f"summary/{key}": value})

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        if self._fh is not None:
            self._fh.close()

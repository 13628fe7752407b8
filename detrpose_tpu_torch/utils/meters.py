"""Windowed training meters with ETA, and the dual best-AP holder.

An own copy of ``detrpose_tpu/utils/meters.py`` (pure Python, the same
strings and bests), mirroring the reference's MetricLogger / SmoothedValue
(src/misc/logger.py:13-240) and its metrics holder (src/misc/metrics.py).
The trainer runs on one device, so no meter needs a cross-rank reduction.
"""
from __future__ import annotations

import datetime
import time
from collections import deque
from typing import Dict, Iterable, Optional


class SmoothedValue:
    """Track a series over a sliding window; report median/avg/global avg.

    Reference: src/misc/logger.py:13-74.
    """

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


class MetricLogger:
    """Iteration logger with windowed meters, iter/data timing, and ETA.

    Reference: src/misc/logger.py:147-240, minus its CUDA memory field (the
    JAX package's lines carry none either; ``chip_smoke.py`` reports the
    peak device memory).
    """

    def __init__(self, delimiter: str = "  ", window_size: int = 20):
        self.meters: Dict[str, SmoothedValue] = {}
        self.delimiter = delimiter
        self.window_size = window_size

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if k not in self.meters:
                self.meters[k] = SmoothedValue(self.window_size)
            self.meters[k].update(float(v))

    def __getattr__(self, name: str) -> SmoothedValue:
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None,
                  log_fn=print):
        """Yield from iterable, logging every print_freq iterations with ETA."""
        total = total if total is not None else len(iterable)  # type: ignore
        i = 0
        start = time.time()
        iter_time = SmoothedValue(self.window_size, fmt="{avg:.4f}")
        data_time = SmoothedValue(self.window_size, fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * (total - i)
                log_fn(self.delimiter.join([
                    header, f"[{i}/{total}]",
                    f"eta: {datetime.timedelta(seconds=int(eta))}",
                    str(self),
                    f"time: {iter_time}", f"data: {data_time}",
                ]))
            i += 1
            end = time.time()
        elapsed = time.time() - start
        log_fn(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
               f"({elapsed / max(total, 1):.4f} s / it)")


class BestMetricHolder:
    """Best-AP tracking for regular AND EMA weights separately, plus the
    overall best (reference: src/misc/metrics.py:12-84; the reference trainer
    evaluates only the EMA module and feeds one stream, trainer.py:240-266 —
    here ``train/trainer.py::Trainer.fit`` evaluates both weight sets per
    epoch when EMA is on)."""

    def __init__(self, use_ema: bool = False):
        self.use_ema = use_ema
        self.best_all = {"best_res": 0.0, "best_ep": -1}
        if use_ema:
            self.best_ema = {"best_res": 0.0, "best_ep": -1}
            self.best_regular = {"best_res": 0.0, "best_ep": -1}

    @staticmethod
    def _upd(slot, res, ep):
        if res > slot["best_res"]:
            slot["best_res"], slot["best_ep"] = res, ep
            return True
        return False

    def update(self, new_res: float, epoch: int, is_ema: bool = False) -> bool:
        """Returns True iff new_res is the new overall best."""
        if self.use_ema:
            self._upd(self.best_ema if is_ema else self.best_regular,
                      new_res, epoch)
        return self._upd(self.best_all, new_res, epoch)

    def update_stream(self, new_res: float, epoch: int,
                      is_ema: bool = False) -> bool:
        """Like update(), but returns True iff new_res improves ITS OWN
        stream's best (the reference gates checkpoint_best_regular on the
        overall best, trainer.py:266-268, but it only ever evaluates one
        stream; with two real streams the per-stream signal is what must
        gate the per-stream best checkpoints — otherwise summary() can
        record a stream-best epoch whose checkpoint was never written)."""
        if not self.use_ema:
            return self.update(new_res, epoch, is_ema)
        stream_new = self._upd(self.best_ema if is_ema else self.best_regular,
                               new_res, epoch)
        self._upd(self.best_all, new_res, epoch)
        return stream_new

    def summary(self) -> dict:
        if not self.use_ema:
            return dict(self.best_all)
        out = {f"all_{k}": v for k, v in self.best_all.items()}
        out.update({f"regular_{k}": v for k, v in self.best_regular.items()})
        out.update({f"ema_{k}": v for k, v in self.best_ema.items()})
        return out

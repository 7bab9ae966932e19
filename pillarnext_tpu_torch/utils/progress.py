"""Terminal progress bar + timers (parity: trainer/utils/progressbar.py).

The port's own copy of pillarnext_tpu/utils/progress.py."""

from __future__ import annotations

import sys
import time


class Timer:
    """Context-manager stopwatch (progressbar.py Timer)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False

    def since_start(self) -> float:
        return time.perf_counter() - self.start


class ProgressBar:
    """tasks/s + ETA progress bar for the eval loop (progressbar.py:7-125)."""

    def __init__(self, task_num: int, bar_width: int = 50, stream=None):
        self.task_num = task_num
        self.bar_width = bar_width
        self.completed = 0
        self.stream = stream or sys.stdout
        self.start_time = time.perf_counter()

    def update(self, n: int = 1):
        self.completed += n
        elapsed = max(time.perf_counter() - self.start_time, 1e-9)
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / self.task_num
            eta = (self.task_num - self.completed) / max(fps, 1e-9)
            mark = int(self.bar_width * pct)
            bar = ">" * mark + " " * (self.bar_width - mark)
            self.stream.write(
                f"\r[{bar}] {self.completed}/{self.task_num}, "
                f"{fps:.1f} task/s, elapsed: {int(elapsed)}s, ETA: {int(eta)}s"
            )
            if self.completed >= self.task_num:
                self.stream.write("\n")
        else:
            self.stream.write(
                f"completed: {self.completed}, elapsed: {int(elapsed)}s, {fps:.1f} tasks/s"
            )
        self.stream.flush()

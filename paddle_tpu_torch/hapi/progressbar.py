"""Minimal terminal progress meter for hapi fit loops — the port of
`paddle_tpu/hapi/progressbar.py` (reference:
python/paddle/hapi/progressbar.py)."""
from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, stream=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self._stream = stream
        # per-step timing is elapsed math -> perf_counter, not wall clock
        self._start = time.perf_counter()
        self._last_update = 0

    def _format_values(self, values):
        parts = []
        for k, v in values:
            if isinstance(v, (float,)):
                parts.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple)):
                parts.append(f"{k}: " + ",".join(f"{x:.4f}" for x in v))
            else:
                parts.append(f"{k}: {v}")
        return " - ".join(parts)

    def update(self, current_num, values=None):
        if self._verbose == 0:
            return
        now = time.perf_counter()
        msg = self._format_values(values or [])
        if self._num:
            prefix = f"step {current_num}/{self._num}"
        else:
            prefix = f"step {current_num}"
        elapsed = now - self._start
        per = elapsed / max(current_num, 1)
        line = f"{prefix} - {per*1000:.0f}ms/step - {msg}"
        if self._verbose == 1:
            self._stream.write("\r" + line)
            if self._num and current_num >= self._num:
                self._stream.write("\n")
            self._stream.flush()
        elif self._verbose == 2:
            self._stream.write(line + "\n")
            self._stream.flush()
        self._last_update = now

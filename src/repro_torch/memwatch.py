"""Peak-RSS measurement shared by benchmarks and the launch scripts.

A copy of ``repro.memwatch``. In the port ``chip_smoke.py`` scopes it
around the streaming fit and holds the delta to ``2 x working_set_model``.

The streaming pipeline's acceptance criteria are memory ceilings ("peak
RSS delta below 2x the modeled working set"), so the measurement lives
next to the library code that both the single-host benchmark
(``benchmarks/fig_streaming_scale.py``) and the multi-host launch path
(``repro.launch.fit_gp --distributed-hosts``) need: every fitting
process — including spawned ranks — scopes a sampler around its fit
region and reports the same statistic.
"""
from __future__ import annotations

import threading


def _status_kb(field: str) -> int | None:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


class PeakRssSampler:
    """Track peak VmRSS over a region by polling /proc/self/status.

    VmHWM + clear_refs would be exact, but clear_refs is often denied in
    containers; a 5ms poll reliably catches the sustained allocations a
    working-set ceiling is about (chunk windows, packed arrays, device
    buffers), everywhere /proc exists. ``stop()`` returns peak minus
    the baseline captured at ``start()``, in bytes.
    """

    def __init__(self, interval_s: float = 0.005):
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.baseline_kb = None
        self.peak_kb = None

    def _run(self):
        while not self._stop.is_set():
            kb = _status_kb("VmRSS")
            if kb is not None and (self.peak_kb is None or kb > self.peak_kb):
                self.peak_kb = kb
            self._stop.wait(self._interval)

    def start(self) -> "PeakRssSampler":
        self.baseline_kb = _status_kb("VmRSS")
        self.peak_kb = self.baseline_kb
        if self.baseline_kb is not None:
            self._thread.start()
        return self

    def stop(self) -> int | None:
        """Peak-minus-baseline in bytes, or None if /proc is unreadable."""
        self._stop.set()
        if self.baseline_kb is None:
            return None
        self._thread.join(timeout=5.0)
        kb = _status_kb("VmRSS")  # catch a final high-water at stop time
        if kb is not None and kb > self.peak_kb:
            self.peak_kb = kb
        return max(self.peak_kb - self.baseline_kb, 0) * 1024

"""CSV logger with state markers + telemetry hooks.

Replicates the reference Logger (Logger.hpp:30-339, Logger.cpp): CSV rows
``<epoch-ms>,<tag>,<payload>`` with tags comment/state/info/warning/error,
``log_state`` begin/end timeline markers enabling offline phase timing, a
background heartbeat thread, and memory accounting.  Hardware telemetry maps
from the Jetson INA3221 sysfs reads to ``jax.local_devices()`` memory
stats; phase tracing additionally hooks ``jax.profiler`` traces (the
equivalent of the reference's clock() wall timers, SURVEY.md §5).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

_LEVELS = {"error": 1, "warning": 2, "info": 3, "debug": 4}


class Logger:
    """Thread-safe CSV logger (mutex-serialised like Logger.cpp:300-420)."""

    def __init__(self, log_dir: str = "out", filename: str = "ssrlcv.log", level: str = "info"):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, filename)
        self.level = _LEVELS.get(level, 3)
        self._lock = threading.Lock()
        self._file = None
        self._bg_thread: Optional[threading.Thread] = None
        self._bg_stop = threading.Event()

    def _ensure_open(self):
        if self._file is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._file = open(self.path, "a", buffering=1)

    def _write(self, tag: str, payload: str):
        with self._lock:
            self._ensure_open()
            ms = int(time.time() * 1000)
            payload = str(payload).replace("\n", " ")
            self._file.write(f"{ms},{tag},{payload}\n")

    def info(self, msg: str):
        if self.level >= 3:
            self._write("info", msg)

    def warn(self, msg: str):
        if self.level >= 2:
            self._write("warning", msg)

    def err(self, msg: str):
        if self.level >= 1:
            self._write("error", msg)

    def comment(self, msg: str):
        self._write("comment", msg)

    def log_state(self, state: str):
        """Timeline marker row (Logger.cpp:333-360) for offline phase timing."""
        self._write("state", state)

    @contextmanager
    def phase(self, name: str, profile: bool = False):
        """state begin/end pair + optional jax.profiler trace annotation."""
        self.log_state(f"{name}:begin")
        t0 = time.perf_counter()
        if profile:
            import jax.profiler

            with jax.profiler.TraceAnnotation(name):
                yield
        else:
            yield
        dt = time.perf_counter() - t0
        self.log_state(f"{name}:end")
        self.info(f"{name} took {dt:.3f}s")

    def log_device_memory(self):
        """Device/host memory accounting (the LOG_MEM analogue,
        Logger.hpp:114-130): per-device bytes in use when available."""
        try:
            import jax

            for d in jax.local_devices():
                stats = getattr(d, "memory_stats", lambda: None)()
                if stats:
                    self.info(
                        f"device {d.id} mem bytes_in_use={stats.get('bytes_in_use', -1)}"
                        f" peak={stats.get('peak_bytes_in_use', -1)}"
                    )
        except Exception as e:  # telemetry must never take the pipeline down
            self.warn(f"device memory stats unavailable: {e}")

    def start_background_logging(self, rate_s: float = 1.0):
        """Heartbeat thread (startBackgoundLogging, Logger.cpp:782-840)."""
        if self._bg_thread is not None:
            return

        def looper():
            while not self._bg_stop.wait(rate_s):
                self._write("comment", "heartbeat")

        self._bg_stop.clear()
        self._bg_thread = threading.Thread(target=looper, daemon=True)
        self._bg_thread.start()

    def stop_background_logging(self):
        if self._bg_thread is not None:
            self._bg_stop.set()
            self._bg_thread.join(timeout=5)
            self._bg_thread = None

    def close(self):
        self.stop_background_logging()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# Global logger instance (the reference exposes a global ``logger``,
# Logger.cpp:4); output dir is set by the pipeline driver.
logger = Logger()

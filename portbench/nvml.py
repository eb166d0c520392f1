"""The card's used memory, read through NVML while the program runs.

NVML reads the card without a CUDA context, so the harness takes no
memory and no time from the program's process. A thread reads the used
bytes of each card every ``period`` seconds; :meth:`Sampler.stop` gives
the largest reading over the cards. The reading is the card's, every
context on it included: the machine that holds the card puts other
processes' contexts on it now and then.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class Sampler:
    def __init__(self, cards: int, period: float = 0.25):
        self.cards = cards
        self.period = period
        self.peak = 0
        self.error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._nvml = None
        self._handles = []

    def start(self) -> "Sampler":
        try:
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
            if nvml.nvmlInit_v2() != 0:
                raise OSError("nvmlInit_v2 failed")
            for i in range(self.cards):
                h = ctypes.c_void_p()
                if nvml.nvmlDeviceGetHandleByIndex_v2(
                        i, ctypes.byref(h)) != 0:
                    raise OSError(f"no NVML handle for card {i}")
                self._handles.append(h)
            self._nvml = nvml
        except (OSError, AttributeError) as e:
            self.error = str(e)
            return self
        self._read()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _read(self) -> None:
        for h in self._handles:
            m = _Memory()
            if self._nvml.nvmlDeviceGetMemoryInfo(h, ctypes.byref(m)) == 0:
                self.peak = max(self.peak, int(m.used))

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            self._read()

    def stop(self) -> int:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._read()
            self._nvml.nvmlShutdown()
            self._thread = None
        return self.peak

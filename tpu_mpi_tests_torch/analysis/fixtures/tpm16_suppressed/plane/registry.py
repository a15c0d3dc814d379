"""TPM16xx suppressed: the helper's lock is a different instance's."""

import threading


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._vals = {}

    def observe(self, key, v):
        with self._lock:
            self._vals[key] = v
            # _trim runs on the child registry, whose lock is its own
            self._trim()  # tpumt: ignore[TPM1602]

    def _trim(self):
        with self._lock:  # tpumt: ignore[TPM1602]
            self._vals.clear()

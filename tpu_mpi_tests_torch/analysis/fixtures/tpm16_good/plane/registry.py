"""TPM16xx good: the helper runs outside the lock."""

import threading


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._vals = {}

    def observe(self, key, v):
        with self._lock:
            self._vals[key] = v
        self._trim()

    def _trim(self):
        with self._lock:
            self._vals.clear()

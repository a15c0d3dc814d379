"""TPM1602 bad: ``observe`` calls a helper while holding the
non-reentrant lock, and the helper takes it again."""

import threading


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._vals = {}

    def observe(self, key, v):
        with self._lock:
            self._vals[key] = v
            self._trim()  # expect: TPM1602

    def _trim(self):
        with self._lock:  # expect: TPM1602
            self._vals.clear()

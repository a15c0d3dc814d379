"""TPM16xx good (single file): one write per record under a lock."""

import json
import threading


class Sink:
    def __init__(self, path):
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def arm(self, seconds):
        threading.Timer(seconds, self._dump).start()

    def _dump(self):
        with self._lock:
            self._f.write(json.dumps({"kind": "watchdog"}) + "\n")

    def record(self, rec):
        with self._lock:
            self._f.write(json.dumps(rec) + "\n")

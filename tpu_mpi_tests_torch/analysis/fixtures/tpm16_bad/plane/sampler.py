"""TPM1601 bad: ``record`` writes the JSONL under the lock, but the
sampler thread reaches the same write through ``sample`` with none."""

import json
import threading


class Sampler:
    def __init__(self, path):
        self._f = open(path, "a")
        self._lock = threading.Lock()

    def record(self, rec):
        with self._lock:
            self._append(rec)

    def _append(self, rec):
        self._f.write(json.dumps(rec) + "\n")  # expect: TPM1601

    def sample(self):
        self._append({"kind": "mem", "t": 0.0})

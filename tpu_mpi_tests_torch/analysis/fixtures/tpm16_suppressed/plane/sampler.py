"""TPM16xx suppressed: the sampler starts only after the main thread
has stopped writing."""

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
        # handed over: the sampler thread is launched after close_main()
        self._f.write(json.dumps(rec) + "\n")  # tpumt: ignore[TPM1601]

    def sample(self):
        self._append({"kind": "mem", "t": 0.0})

"""TPM16xx suppressed (single file): the dump runs only after the main
thread stopped writing."""

import json
import threading


class Sink:
    def __init__(self, path):
        self._f = open(path, "a")

    def arm(self, seconds):
        threading.Timer(seconds, self._dump).start()

    def _dump(self):
        # the timer fires only after close_main() handed the file over
        self._f.write(json.dumps({"kind": "watchdog"}))  # tpumt: ignore[TPM1601]

    def record(self, rec):
        self._f.write(json.dumps(rec))

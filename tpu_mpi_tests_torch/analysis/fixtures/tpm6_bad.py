"""TPM16xx bad (single file): the watchdog's timer thread and the main
thread write the same JSONL handle with no lock."""

import json
import threading


class Sink:
    def __init__(self, path):
        self._f = open(path, "a")

    def arm(self, seconds):
        threading.Timer(seconds, self._dump).start()

    def _dump(self):
        self._f.write(json.dumps({"kind": "watchdog"}) + "\n")  # expect: TPM1601

    def record(self, rec):
        self._f.write(json.dumps(rec) + "\n")

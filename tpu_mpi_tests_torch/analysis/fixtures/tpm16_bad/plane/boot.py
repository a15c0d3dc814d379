"""The thread entry lives here, a file away from the hazard: the
whole-program pass must see ``s.sample`` escape into the Thread and
tag ``Sampler.sample`` (and what it calls) as a concurrent root."""

import threading

from plane.sampler import Sampler


def launch(path):
    s = Sampler(path)
    threading.Thread(target=s.sample, daemon=True).start()
    return s

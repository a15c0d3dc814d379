"""What a CUDA graph capture of the bench's k=1 schedules costs, and what
the overlap schedule's comm-stream fork costs at world 1, at one commit.

For the bench's two k=1 schedules at 8192² f32 (strong-scaled over the
ranks) — the serialized one (``_ov1``, ``halo.iterate_hand_fn``) and the
overlap one (``_ov2``, ``halo.iterate_overlap_fn``) — and for ``_ov2``
again with a comm stream forked and joined every iteration as it is at
world > 1 (``_ov2_fork``, world 1 only: ``halo._comm_stream`` patched
to fork there too), it
captures ``run(state, n)`` at each ``n`` the way
``instrument.timers.chain_rate`` does (a capture stream, a private pool)
and prints a line::

    CAPTURE <schedule> world=<w> n=<n> capture_s=<s> end_s=<s>
        replay_us=<us> eager_us=<us>

``capture_s`` is the host time of the body's Python under capture,
``end_s`` the time to end the capture (CUDA instantiates the graph
there); a chain_rate chain pays both for each of its two graphs.
``replay_us`` is the device time of a replayed iteration (CUDA events
around one replay, after a first replay that uploads the graph),
``eager_us`` that of an iteration of the same ``n`` launched eagerly
(events around the Python loop, queued behind a stall so the host is
ahead). The card's name and power limit come first. One process a card:
under ``torchrun`` every rank captures the same sequence and rank 0
prints.

    python gpu/capture_cost.py [N ...]                  # one card
    torchrun --standalone --nproc-per-node 4 gpu/capture_cost.py 100 400
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from tpu_mpi_tests_torch import bench  # noqa: E402
from tpu_mpi_tests_torch.comm import dist  # noqa: E402
from tpu_mpi_tests_torch.comm import halo as H  # noqa: E402
from tpu_mpi_tests_torch.instrument import timers  # noqa: E402

N_DEFAULT = (50, 100, 200, 400)
#: (label, the overlap schedule, a comm stream forked at every world)
SCHEDULES = (("_ov1", False, False), ("_ov2", True, False),
             ("_ov2_fork", True, True))


def _events_us(fn, n: int) -> float:
    """Device µs an iteration of ``fn()`` (``n`` iterations), between two
    events queued behind a stall."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda._sleep(int(2e6))  # ~1 ms: the host queues fn() meanwhile
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    del out
    return ev[0].elapsed_time(ev[1]) * 1e3 / n


def capture_cost(run, state, n: int) -> tuple[float, float, float, float]:
    """``(capture_s, end_s, replay_us, eager_us)`` of ``run(state, n)``
    captured once after a warm eager run."""
    state = timers.block(run(state, 3))
    dev = state.device
    eager = _events_us(lambda: run(state, n), n)
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        g.capture_begin(pool=torch.cuda.graph_pool_handle(),
                        capture_error_mode="thread_local")
        t0 = time.perf_counter()
        out = run(state, n)
        t1 = time.perf_counter()
        g.capture_end()
        t2 = time.perf_counter()
    torch.cuda.current_stream(dev).wait_stream(stream)
    g.replay()  # the first replay uploads the graph
    torch.cuda.synchronize(dev)
    replay = _events_us(g.replay, n)
    del g, out
    return t1 - t0, t2 - t1, replay, eager


def main(argv: list[str]) -> int:
    ns = [int(a) for a in argv] or list(N_DEFAULT)
    w = dist.init("cuda")
    if w.rank == 0:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0], flush=True)
    only_over_ranks = H._comm_stream
    for label, overlap, fork in SCHEDULES:
        if fork and w.size > 1:
            continue  # _ov2 forks over ranks already
        if fork:
            H._comm_stream = lambda z, ring: torch.cuda.Stream(z.device)
        try:
            run, state, _, _ = bench.build_schedule(
                "float32", n=8192, steps=1, n_blocks=0, tier="blocks",
                device=w.device, overlap=overlap)
            for n in ns:
                cap, end, rep, eager = capture_cost(run, state, n)
                if w.rank == 0:
                    print(f"CAPTURE {label} world={w.size} n={n} "
                          f"capture_s={cap:.4f} end_s={end:.4f} "
                          f"replay_us={rep:.2f} eager_us={eager:.2f}",
                          flush=True)
            del run, state
        finally:
            H._comm_stream = only_over_ranks
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""TPM210 suppressed: a print at capture time that says it runs once,
at capture, and is meant to."""

from tpu_mpi_tests_torch.instrument.timers import chain_rate


def chained(step, x):
    def run(y, n):
        # the one line at capture names the captured chain's length
        print(f"capturing {n} steps")  # tpumt: ignore[TPM210]
        for _ in range(n):
            y = step(y)
        return y

    return chain_rate(run, x)

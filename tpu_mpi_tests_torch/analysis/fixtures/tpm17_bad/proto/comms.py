"""Wrappers: the collective with its telemetry emitter (the runtime
alphabet the schedule automaton derives), and the broadcast-class
handshake TPM1101's alphabet leaves out."""

import torch.distributed as dist

from tpu_mpi_tests_torch.instrument.telemetry import comm_span
from tpu_mpi_tests_torch.tune.fleet import bcast


def global_sum(t):
    with comm_span("allreduce", axis_name="shard"):
        dist.all_reduce(t)
    return t


def fanout(value, tag):
    return bcast(value, tag)

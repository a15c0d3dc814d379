"""TPM10xx good: the driver leaves arming to drivers/_common."""

from tpu_mpi_tests_torch.drivers import _common


def run(args):
    with _common.make_reporter(args) as rep:
        rep.line("ok")

"""The port's rule registry: one module per carried family.

Codes keep the JAX package's meanings (a code is never reused for a
different hazard), so a suppression means the same in both trees. The
families that do not carry over leave their codes unused: TPM201 trace
purity (the port has no traced functions; its TPM2xx code is TPM210,
capture purity, for the bodies it captures into CUDA graphs), TPM301
(torch's float32 default is documented behaviour, not a flag), TPM5xx
axis consistency (process groups are objects, not named mesh axes) and
TPM12xx donation (torch has no ``donate_argnums``). File-scope rules see
one parsed file; project-scope rules see the whole linted program as
serialized facts (``analysis/program.py``).
"""

from tpu_mpi_tests_torch.analysis.rules.broadcast_consistency import (
    BroadcastConsistency,
)
from tpu_mpi_tests_torch.analysis.rules.capture_purity import CapturePurity
from tpu_mpi_tests_torch.analysis.rules.chaos_containment import (
    ChaosContainment,
)
from tpu_mpi_tests_torch.analysis.rules.collective_divergence import (
    CollectiveDivergence,
)
from tpu_mpi_tests_torch.analysis.rules.concurrency import (
    UnlockedSharedWrite,
)
from tpu_mpi_tests_torch.analysis.rules.early_exit_divergence import (
    EarlyExitDivergence,
)
from tpu_mpi_tests_torch.analysis.rules.epoch_precision import (
    EpochPrecision,
)
from tpu_mpi_tests_torch.analysis.rules.import_hygiene import ImportHygiene
from tpu_mpi_tests_torch.analysis.rules.overlap_regions import (
    EscapedAsyncHandle,
    OverlapRegionSync,
)
from tpu_mpi_tests_torch.analysis.rules.races import LocksetRaces
from tpu_mpi_tests_torch.analysis.rules.record_contract import (
    RecordContract,
)
from tpu_mpi_tests_torch.analysis.rules.schedule_constants import (
    ScheduleConstants,
)
from tpu_mpi_tests_torch.analysis.rules.schedule_protocol import (
    ScheduleProtocol,
)
from tpu_mpi_tests_torch.analysis.rules.sync_honesty import (
    InterprocSyncHonesty,
    SyncHonesty,
)

ALL_RULES = [
    SyncHonesty(),
    InterprocSyncHonesty(),
    CapturePurity(),
    EpochPrecision(),
    ImportHygiene(),
    UnlockedSharedWrite(),
    LocksetRaces(),
    ScheduleConstants(),
    OverlapRegionSync(),
    EscapedAsyncHandle(),
    ChaosContainment(),
    CollectiveDivergence(),
    EarlyExitDivergence(),
    BroadcastConsistency(),
    RecordContract(),
    ScheduleProtocol(),
]

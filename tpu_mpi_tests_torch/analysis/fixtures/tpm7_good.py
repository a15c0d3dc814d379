"""TPM7xx good: the candidates declared where the knob lives."""

from tpu_mpi_tests_torch.tune.registry import declare_space

HALO_PIPELINE_SPACE = declare_space(
    "halo/pipeline", (1, 2), describe="exchange pipeline depth"
)
TILE_NAME = "rows"

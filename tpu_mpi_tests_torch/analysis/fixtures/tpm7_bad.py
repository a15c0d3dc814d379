"""TPM7xx bad: hand-pinned schedule constants outside the tuner."""

FLASH_TILE_ROWS = 128  # expect: TPM701
HALO_PIPELINE_DEPTH = 2  # expect: TPM701
_KSTEP_STEPS = (1, 2, 4, 8)  # expect: TPM701

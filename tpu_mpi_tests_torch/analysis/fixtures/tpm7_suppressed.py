"""TPM7xx suppressed: a compile-time CUDA geometry, no knob."""

# mirrors kQT of the kernel source: the tuner cannot move it
FLASH_Q_TILE = 64  # tpumt: ignore[TPM701]

"""TPM9xx bad: a suppression whose finding is gone, and a malformed
marker."""

x = 1  # tpumt: ignore[TPM101]  # expect: TPM900
y = 2  # tpumt: ignore  # expect: TPM901

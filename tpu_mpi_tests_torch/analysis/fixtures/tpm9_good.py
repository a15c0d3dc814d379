"""TPM9xx good: no stale or malformed suppressions."""

x = 1

"""TPM17xx tree: each file's branches look locally symmetric to the
per-branch TPM11xx rules; the hazards exist only in the composed
whole-program schedule."""

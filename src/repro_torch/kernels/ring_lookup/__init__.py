"""Ring lookup kernels: K1 (flat) and K2 (bucketed)."""

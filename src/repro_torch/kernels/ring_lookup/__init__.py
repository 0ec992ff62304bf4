"""Ring lookup kernels: K1 (flat), K2 (bucketed) and K7 (single-word)."""

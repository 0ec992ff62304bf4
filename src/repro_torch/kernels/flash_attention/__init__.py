"""Flash-attention kernel: K5."""

"""Selective-scan kernel: K6."""

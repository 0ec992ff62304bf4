"""Decode attention kernel: K3."""

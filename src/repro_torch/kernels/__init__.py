"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each ``<name>/`` package mirrors ``repro.kernels.<name>``: ``ref.py`` (the
plain version, used for CPU tensors and as the oracle on the card),
``kernel.py`` (the launcher of the CUDA source under ``csrc/``) and
``ops.py`` (the public wrapper that picks by the tensors' device and
counts launches).
"""

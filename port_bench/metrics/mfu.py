"""The model FLOPs of the tokens the window processed over the window and
the H100's bf16 peak (989 TFLOP/s), in %: the whole step's share of the
chip's peak (``harness/work.py`` holds the arithmetic)."""
from harness.readers import mfu as read  # noqa: F401

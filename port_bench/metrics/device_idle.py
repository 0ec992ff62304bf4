"""The share of the traced window in which no operation ran on the device
(``torch.profiler``: one minus the union of the device events over the
window), in %."""
from harness.readers import device_idle as read  # noqa: F401

"""Device resolution, provenance and the bucket budget of the port.

Every entry point of the port runs on the CUDA card unless the caller
asks for the CPU: ``resolve_device(None)`` returns the current CUDA
device, and raises when there is none instead of falling back to the
host.  Kernel wrappers decide by the device of the tensors they are
given: CPU tensors take the plain PyTorch versions, CUDA tensors launch
the CUDA kernels (``kernels/build.py``), and ``meta`` tensors (the dry
run's) take a meta route that only makes the outputs' shapes and dtypes.

``charge`` and ``charged`` are how a kernel, or a collective, tells a
cost counter (``launch.hlo_cost.CostCounter``) the work it must do, on
the card and on ``meta`` alike.
"""
from __future__ import annotations

import contextlib
import subprocess
from typing import Dict, Optional

import torch

from .build import KernelLaunchError

# what a serve path must never absorb into a degrade-to-recompute: a
# kernel's failed launch, or an error the CUDA runtime reported
DEVICE_FAULTS = (KernelLaunchError, torch.AcceleratorError)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device=\"cpu\" to run "
                "on the host with the kernels' plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def charge(name: str, work: Dict[str, object]) -> list:
    """Charge ``work`` (a kernel's ``bytes``, ``matmul_flops`` and
    ``ops``, or a collective's ``collective`` kind and ``bytes``) under
    ``name`` to every cost counter active in the calling thread (the
    torch dispatch modes with a ``charge`` method); returns them.  The
    dispatch-mode stack follows the autograd engine into the card's
    backward thread, so a backward kernel is charged there too."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    counters = [m for m in _get_current_dispatch_mode_stack()
                if callable(getattr(m, "charge", None))]
    for c in counters:
        c.charge(name, work)
    return counters


@contextlib.contextmanager
def charged(name: str, work: Dict[str, object]):
    """``charge``, and hide from the counters the aten ops the block runs:
    a kernel's launch or meta route, or a collective's sends, is counted
    by the work it must do, not by what its wrapper allocates, copies or
    pads."""
    counters = charge(name, work)
    for c in counters:
        c.hidden += 1
    try:
        yield
    finally:
        for c in counters:
            c.hidden -= 1


def bucket_budget_bytes(device) -> int:
    """Upper bound on the bucketized ring-lookup matrix (DESIGN.md §7).

    The bucketized kernel (K2) gathers one random 1 KiB row pair (hi and
    lo words, 128 slots each) per key, so its speed depends on the
    (B, 128) matrix staying resident in the L2 cache: the budget on CUDA
    is the largest power of two <= the card's L2 size, which is 32 MiB
    on an H100 (50 MB of L2).  A 10^6-peer ring (capacity 2^20) then
    gets its full 2^15-bucket directory (32 MiB, ~31 ids per bucket) and
    stays on the bucketed path.  (``repro``'s 8 MB compiled-backend
    budget, sized for TPU VMEM, would clamp it to 8192 buckets of ~122
    ids: some rows overflow the 128 slots, escalation cannot grow within
    8 MB, and every lookup falls back to the O(n) flat scan.)

    On the CPU the plain versions only use host RAM: 256 MiB, as in
    ``repro``'s interpret mode.
    """
    device = torch.device(device)
    if device.type == "cuda":
        l2 = int(torch.cuda.get_device_properties(device).L2_cache_size)
        return 1 << (l2.bit_length() - 1)
    return 256 << 20


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, for a kernel launch,
    without building a ``torch.cuda.Stream`` (host time a launch pays)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def nvidia_smi_line() -> Optional[str]:
    """``name, power.limit`` of the cards as nvidia-smi prints them, or
    None where nvidia-smi is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def provenance(device=None) -> dict:
    """Measurement provenance: torch/CUDA versions, the device and its
    name and power limit as nvidia-smi gives them, and whether the CUDA
    kernels (CUDA tensors) or the plain versions (CPU tensors) ran."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 0,
        "nvidia_smi": nvidia_smi_line() if on_card else None,
        "kernels": "cuda" if on_card else "plain",
    }


def synchronize(device: torch.device) -> None:
    """Wait for the device's work (a no-op on the host)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def strict_fp32() -> None:
    """Full-f32 products on the card: TF32 off for matmuls and cuDNN (a
    float32 convolution would otherwise run in TF32, which keeps ~3
    decimal digits).  The port's f32 logits and the f32 model tests
    rely on it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

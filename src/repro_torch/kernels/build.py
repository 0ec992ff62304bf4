"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, and the objects are linked into
``build/repro_torch/libkernels-<hash>.so`` at the root of the checkout,
keyed by a hash of the sources and flags, then loaded with ``ctypes``.
The sources have a plain C interface and include no PyTorch header, so a
build takes seconds.  Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; ``launch`` raises when that is
not 0.  A failed build raises: nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    # keys_hi, keys_lo, table_hi, table_lo, n, out, q, stream
    "ring_lookup64_launch": [_P] * 6 + [_L, _P],
    # keys, table, out, q, n, stream
    "ring_lookup_launch": [_P] * 3 + [_L, _I, _P],
    # keys, table, sample scratch, out, q, n, stream
    "ring_lookup_sampled_launch": [_P] * 4 + [_L, _I, _P],
    # keys_hi, keys_lo, bkt_hi, bkt_lo, occ, out_hi, out_lo, q, bits, stream
    "ring_lookup_bucketed_launch": [_P] * 7 + [_L, _I, _P],
    # q, k, v, length, out, m_part, l_part, acc_part,
    # B, S, H, Hkv, hd, splits, dtype, vec, scale, stream
    "decode_attention_launch": [_P] * 8 + [_I] * 8 + [_F, _P],
    # q, k, v, length, out, partials, counters,
    # B, S, H, Hkv, hd, chunk, dtype, scale, stream (the tensor-core route)
    "decode_attention_tc_launch": [_P] * 7 + [_I] * 7 + [_F, _P],
    # offset, n, reporter, t_detect, event_key, ack, ttl, depth, parent,
    # sends, p, levels, variant, theta, inv_theta, e_buf, e_cap_m1,
    # inv_fill, delta, phase_key (a uint32: c_int would wrap >= 2^31), stream
    "edra_tree_launch": [_P] * 10 + [_L, _I, _I] + [_F] * 6
    + [ctypes.c_uint32, _P],
    # q, k, v, out, B, Sq, Sk, H, Hkv, hd (q and k), hdv (v and out),
    # causal, dtype, scale, stream
    "flash_attention_launch": [_P] * 4 + [_I] * 9 + [_F, _P],
    # the same arguments (the tensor-core route)
    "flash_attention_tc_launch": [_P] * 4 + [_I] * 9 + [_F, _P],
    # x, dt, B, C, A, D, h0 (or 0), y, h_last, Bb, L, Din, N, dtype, stream
    "ssm_scan_launch": [_P] * 9 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log = ""                           # nvcc's -Xptxas=-v report
library_path: Optional[Path] = None      # the loaded shared library


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_so),
             *map(str, objs)], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, target)     # atomic: concurrent builds agree
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib, build_seconds, build_log, library_path
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libkernels-{_digest()}.so"
            t0 = time.perf_counter()
            if not target.exists():
                build_log = _compile(target)
            build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            library_path = target
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise on a non-zero CUDA error code."""
    lib = library()
    code = getattr(lib, name)(*args)
    if code:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")

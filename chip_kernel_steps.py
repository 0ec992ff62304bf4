#!/usr/bin/env python3
"""What holds K3 (decode attention) and K2 (bucketed ring lookup) back,
and what each step of their redesign buys, on one card.

    python3 chip_kernel_steps.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (as ``chip_smoke.py``
does) and prints one JSON line per measurement.  ``ms`` is the CUDA-event
mean of 30 back-to-back calls (``chip_smoke.cuda_ms``), which the host's
work per call bounds when a kernel is short; ``device_ms`` is the kernels'
own time, the median of three torch.profiler windows of 20 calls.  K3's
inputs are cycled past the 50 MB L2, as on the serve path, where each
layer's cache is cold:

  k3_simt   the SIMT kernel (``decode_attention_launch``: split kernel +
            combine kernel) at qwen2.5-3b's heads, S 2048, bf16, lengths
            random in [1, S], B 1, 8, 16, 32: with today's split plan
            (``kernel.num_splits``), then with a grid that grows with the
            work (splits = S / C for C = 256, 128, 64 positions), by
            device time (torch.profiler) and by the CUDA-event time of
            back-to-back calls; the share of its device time in the split
            and the combine kernel; and its rate over the valid K/V bytes;
  k2        the wrapper's kernel (``ops.ring_lookup_bucketed``) at Q 2^20
            on a 10^6-peer directory, with random keys and with the same
            keys sorted (sorted keys make neighbouring keys read the same
            rows, so what sorting buys is the cost of the row traffic), and
            at Q 32 (the fused round's full house);
  k3_tc     where the tensor-core route exists: chunk sizes C = 64, 128,
            256, 512 and the wrapper's plan (``ops.decode_attention``), and
            the ring of K/V tiles at 1, 2 and 3 stages (builds of
            ``csrc/decode_attention_tc.cu`` with ``kStages`` patched), B 1, 8,
            16, 32, beside the SIMT kernel and SDPA, by device time
            (torch.profiler) and by the CUDA-event time of back-to-back
            calls;
  k2_alternatives  beside the tensor-core route: K2's kernel against a
            thread a key with the lower bound over the whole live prefix
            (``K2_BISECT_CU`` below), 8 lanes a key (``K2_LANES8_CU``) and
            a 16-slot window (``kWindow`` patched to 16), at the same keys,
            by event and device time; then the window route alone and the
            warp-a-key route alone (``kK2WarpKeys`` patched) at Q from 32 to
            2^16, by device time, which places the launcher's choice.

Then nvidia-smi's name and power limit as the last line.  Imports no jax.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

H, HKV, HD = smoke.H, smoke.HKV, smoke.HD
S = 2048
BATCHES = (1, 8, 16, 32)
K2_SWEEP = (32, 256, 1024, 4096, 16384, 65536)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def k3_inputs(dev, b, gen):
    """Copies of (q, k, v) cycled past the L2, and one length vector."""
    import torch
    per = 2 * b * S * HKV * HD * 2
    copies = max(1, math.ceil(128e6 / per))
    q = torch.randn((copies, b, H, HD), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((copies, b, S, HKV, HD), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((copies, b, S, HKV, HD), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    length = torch.randint(1, S + 1, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    return q, k, v, length, copies


def simt_call(q, k, v, length, splits):
    """The SIMT kernel's entry point with a given split count."""
    import torch
    from repro_torch.kernels import build
    b, h, hd = q.shape
    hkv = k.shape[2]
    g = h // hkv
    out = torch.empty_like(q)
    m_part = torch.empty((b, hkv, splits, g), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, hkv, splits, g, hd), dtype=torch.float32,
                           device=q.device)
    build.launch("decode_attention_launch", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), length.data_ptr(), out.data_ptr(),
                 m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
                 b, k.shape[1], h, hkv, hd, splits, 1, 1, 1.0 / math.sqrt(hd),
                 torch.cuda.current_stream(q.device).cuda_stream)
    return out


def profile_split(fn, steps=20):
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
    return {r.key[:60]: r.self_device_time_total / 1e3 / steps
            for r in prof.key_averages() if r.self_device_time_total > 0}


def device_ms(fn, windows=3):
    """Device ms per call of ``fn``, all its kernels together: the median
    of ``windows`` profiled windows of 20 calls."""
    return float(np.median([sum(profile_split(fn).values())
                            for _ in range(windows)]))


def k3_simt(dev, gen):
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    for b in BATCHES:
        q, k, v, length, copies = k3_inputs(dev, b, gen)
        want = decode_attention_ref(q[0], k[0], v[0], length)
        valid = int(length.sum())
        nbytes = valid * HKV * HD * 2 * 2
        plans = {"today": dk.num_splits(b, HKV, S)}
        plans.update({f"C{c}": S // c for c in (256, 128, 64)})
        row = {"B": b, "valid_positions": valid, "kv_bytes": nbytes,
               "bound_ms": nbytes / smoke.MEM_BYTES_PER_S * 1e3}
        for name, splits in plans.items():
            got = simt_call(q[0], k[0], v[0], length, splits)
            err = float((got.float() - want.float()).abs().max())
            if not err <= smoke.BF16_ATOL:
                raise AssertionError(f"SIMT K3 B={b} {name}: err {err}")
            fn = lambda i: simt_call(q[i % copies], k[i % copies],  # noqa
                                     v[i % copies], length, splits)
            dms = device_ms(fn)
            row[name] = {"splits": splits, "blocks": splits * b * HKV,
                         "ms": smoke.cuda_ms(fn), "device_ms": dms,
                         "tb_per_s": nbytes / dms / 1e9}
        row["today_kernels_ms"] = profile_split(lambda i: simt_call(
            q[i % copies], k[i % copies], v[i % copies], length,
            plans["today"]))
        emit({"phase": "k3_simt", **row})
        del q, k, v
        torch.cuda.empty_cache()


def k2_directory(dev):
    from repro_torch.core.ringstate import RingState
    rng = np.random.default_rng(smoke.SEED)
    ids = np.unique(rng.integers(0, 2**64, size=smoke.N_PEERS + 4096,
                                 dtype=np.uint64))
    ids = ids[rng.permutation(ids.size)[:smoke.N_PEERS]]
    state = RingState(ids, device=dev)
    keys = rng.integers(0, 2**64, size=smoke.N_KEYS, dtype=np.uint64)
    return state, keys


def words(keys, dev):
    import torch
    w = np.uint64(32)
    return (torch.from_numpy((keys >> w).astype(np.uint32).view(np.int32))
            .to(dev),
            torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                             .view(np.int32)).to(dev))


def k2(dev):
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    state, keys = k2_directory(dev)
    table = state.device_bucket_table()
    row = {}
    for name, ks in k2_cases(keys).items():
        khi, klo = words(ks, dev)
        fn = lambda i: rl_ops.ring_lookup_bucketed(khi, klo,  # noqa: E731
                                                   *table)
        row[name] = {"ms": smoke.cuda_ms(fn), "device_ms": device_ms(fn)}
    emit({"phase": "k2", "buckets": state.bucket_stats()["buckets"], **row})


def k2_cases(keys):
    return {"random_2^20": keys, "sorted_2^20": np.sort(keys),
            "random_32": keys[:32]}


# K2's measured alternatives, each with the entry point of
# csrc/ring_lookup.cu: a thread a key running the branchless lower bound
# over the whole live prefix (no window; ~6 dependent probes), and 8 lanes
# a key, each round probing 8 splitters of the live prefix at once (a
# ballot counts those below the key: 2 rounds at 31 live slots)
K2_BISECT_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
__global__ void k2_bisect(const uint32_t* __restrict__ keys_hi,
                          const uint32_t* __restrict__ keys_lo,
                          const uint32_t* __restrict__ bkt_hi,
                          const uint32_t* __restrict__ bkt_lo,
                          const int32_t* __restrict__ occ, uint32_t* out_hi,
                          uint32_t* out_lo, int64_t q, int bits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= q) return;
  const uint32_t kh = keys_hi[i], kl = keys_lo[i];
  const uint32_t b = bits > 0 ? (kh >> (32 - bits)) : 0u;
  const uint32_t* row_hi = bkt_hi + static_cast<size_t>(b) * 128;
  const uint32_t* row_lo = bkt_lo + static_cast<size_t>(b) * 128;
  const int live = occ[b];
  int base = 0, len = live;
  const auto below = [&](int j) {
    const uint32_t h = row_hi[j];
    return h < kh || (h == kh && row_lo[j] < kl);
  };
  while (len > 1) {
    const int half = len >> 1;
    base = below(base + half) ? base + half : base;
    len -= half;
  }
  const int count = min(live > 0 ? base + below(base) : 0, 127);
  out_hi[i] = row_hi[count];
  out_lo[i] = row_lo[count];
}
}  // namespace
extern "C" int ring_lookup_bucketed_launch(const void* kh, const void* kl,
    const void* bh, const void* bl, const void* occ, void* oh, void* ol,
    int64_t q, int bits, void* stream) {
  k2_bisect<<<static_cast<unsigned>((q + 255) / 256), 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kh), static_cast<const uint32_t*>(kl),
      static_cast<const uint32_t*>(bh), static_cast<const uint32_t*>(bl),
      static_cast<const int32_t*>(occ), static_cast<uint32_t*>(oh),
      static_cast<uint32_t*>(ol), q, bits);
  return static_cast<int>(cudaGetLastError());
}
"""

K2_LANES8_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int kLanes = 8;
__global__ void k2_lanes8(const uint32_t* __restrict__ keys_hi,
                          const uint32_t* __restrict__ keys_lo,
                          const uint32_t* __restrict__ bkt_hi,
                          const uint32_t* __restrict__ bkt_lo,
                          const int32_t* __restrict__ occ, uint32_t* out_hi,
                          uint32_t* out_lo, int64_t q, int bits) {
  const int64_t i = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / kLanes;
  const int j = threadIdx.x % kLanes;
  const unsigned group = 0xffu << ((threadIdx.x & 31) & ~(kLanes - 1));
  if (i >= q) return;
  const uint32_t kh = keys_hi[i], kl = keys_lo[i];
  const uint32_t b = bits > 0 ? (kh >> (32 - bits)) : 0u;
  const uint32_t* row_hi = bkt_hi + static_cast<size_t>(b) * 128;
  const uint32_t* row_lo = bkt_lo + static_cast<size_t>(b) * 128;
  int base = 0, len = occ[b];
  while (len > 0) {
    const int step = (len + kLanes) / (kLanes + 1);
    const int at = (j + 1) * step;
    bool lt = false;
    if (at <= len) {
      const uint32_t h = row_hi[base + at - 1];
      lt = h < kh || (h == kh && row_lo[base + at - 1] < kl);
    }
    const int c = __popc(__ballot_sync(group, lt) & group);
    base += c * step;
    len = c == kLanes ? len - c * step : min(step - 1, len - c * step);
  }
  const int count = min(base, 127);
  if (j == 0) {
    out_hi[i] = row_hi[count];
    out_lo[i] = row_lo[count];
  }
}
}  // namespace
extern "C" int ring_lookup_bucketed_launch(const void* kh, const void* kl,
    const void* bh, const void* bl, const void* occ, void* oh, void* ol,
    int64_t q, int bits, void* stream) {
  const int64_t blocks = (q * kLanes + 255) / 256;
  k2_lanes8<<<static_cast<unsigned>(blocks), 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kh), static_cast<const uint32_t*>(kl),
      static_cast<const uint32_t*>(bh), static_cast<const uint32_t*>(bl),
      static_cast<const int32_t*>(occ), static_cast<uint32_t*>(oh),
      static_cast<uint32_t*>(ol), q, bits);
  return static_cast<int>(cudaGetLastError());
}
"""


def variant_library(name: str, src: Path, swaps=None):
    """One CUDA source built into build/steps/, with its entry points typed
    as ``build.SIGNATURES`` types them.  ``swaps`` maps lines of the source
    to their replacements: the variant is a patched copy, and each line
    must be found once."""
    from repro_torch.kernels import build
    if swaps:
        text = src.read_text()
        for old, new in swaps.items():
            if text.count(old) != 1:
                raise AssertionError(f"{src.name}: {old!r} not found once")
            text = text.replace(old, new)
        src = build_dir_source(f"{name}.cu", text)
    out = build.BUILD_DIR / "steps" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    f"-I{build.CSRC}", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for entry, argtypes in build.SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def checked(code: int) -> None:
    if code:
        raise RuntimeError(f"CUDA error {code}")


def tc_launch(lib, q, k, v, length, chunk):
    """The tensor-core entry point of ``lib`` with a given chunk, on the
    wrapper's scratch."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dk
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, count = dk.tc_scratch(q.device, stream, b * hkv,
                                b * -(-s // chunk) * h * (hd + 2))
    checked(lib.decode_attention_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), part.data_ptr(), count.data_ptr(), b, s, h, hkv, hd,
        chunk, 1, 1.0 / math.sqrt(hd), stream))
    return out


def k3_tc(dev, gen):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    src = build.CSRC / "decode_attention_tc.cu"
    stages = "constexpr int kStages = 3;"
    libs = {f"stages{n}": variant_library(
                f"k3_stages{n}", src, {stages: f"constexpr int kStages = {n};"})
            for n in (1, 2, 3)}
    for b in BATCHES:
        q, k, v, length, copies = k3_inputs(dev, b, gen)
        want = decode_attention_ref(q[0], k[0], v[0], length)
        valid = int(length.sum())
        nbytes = valid * HKV * HD * 2 * 2
        plan = dk.chunk_positions(b, HKV, S)
        row = {"B": b, "plan_chunk": plan,
               "bound_ms": nbytes / smoke.MEM_BYTES_PER_S * 1e3}

        def call(i, lib, chunk):
            j = i % copies
            return tc_launch(lib, q[j], k[j], v[j], length, chunk)

        def timed(fn, what):
            err = float((fn(0).float() - want.float()).abs().max())
            if not err <= smoke.BF16_ATOL:
                raise AssertionError(f"K3 B={b} {what}: err {err}")
            return {"device_ms": device_ms(fn), "ms": smoke.cuda_ms(fn),
                    "err": err}
        for c in (64, 128, 256, 512):
            row[f"C{c}"] = timed(lambda i: call(i, build.library(), c),
                                 f"C{c}")
        for name, lib in libs.items():
            row[name] = timed(lambda i: call(i, lib, plan), name)
        row["simt_today"] = timed(lambda i: simt_call(
            q[i % copies], k[i % copies], v[i % copies], length,
            dk.num_splits(b, HKV, S)), "simt")
        row["simt_C64"] = timed(lambda i: simt_call(
            q[i % copies], k[i % copies], v[i % copies], length, S // 64),
            "simt C64")
        row["plan"] = timed(lambda i: da_ops.decode_attention(
            q[i % copies], k[i % copies], v[i % copies], length), "plan")
        # the yardstick's own device time: SDPA (its default backend) on
        # (B, Hkv, S, hd) copies of the caches, as chip_smoke.py calls it
        kt, vt = k.transpose(2, 3).contiguous(), v.transpose(2, 3).contiguous()
        mask = (torch.arange(S, device=dev)[None, :] < length[:, None])[
            :, None, None, :]

        def sdpa(i):
            j = i % copies
            return torch.nn.functional.scaled_dot_product_attention(
                q[j][:, :, None], kt[j], vt[j], attn_mask=mask,
                enable_gqa=True)
        row["sdpa"] = {"device_ms": device_ms(sdpa), "ms": smoke.cuda_ms(sdpa)}
        del kt, vt
        emit({"phase": "k3_tc", **row})
        del q, k, v
        torch.cuda.empty_cache()


def k2_alternatives(dev):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ring_lookup import ops as rl_ops
    from repro_torch.kernels.ring_lookup.ref import ring_lookup_bucketed_ref
    state, keys = k2_directory(dev)
    table = state.device_bucket_table()
    src = build.CSRC / "ring_lookup.cu"
    window = "constexpr int kWindow = 8;"
    warp_keys = "constexpr int64_t kK2WarpKeys = 4096;"
    libs = {"bisect": variant_library(
                "k2_bisect", build_dir_source("k2_bisect.cu", K2_BISECT_CU)),
            "lanes8": variant_library(
                "k2_lanes8", build_dir_source("k2_lanes8.cu", K2_LANES8_CU)),
            "window16": variant_library(
                "k2_window16", src, {window: "constexpr int kWindow = 16;"}),
            "window_only": variant_library(
                "k2_window_only", src,
                {warp_keys: "constexpr int64_t kK2WarpKeys = 0;"}),
            "warp_only": variant_library(
                "k2_warp_only", src,
                {warp_keys: "constexpr int64_t kK2WarpKeys = INT64_MAX;"})}
    bits = table[0].shape[0].bit_length() - 1
    row = {}
    for name, ks in k2_cases(keys).items():
        khi, klo = words(ks, dev)
        want = ring_lookup_bucketed_ref(khi, klo, *table)

        def alt(i, lib):
            oh, ol = torch.empty_like(khi), torch.empty_like(klo)
            checked(lib.ring_lookup_bucketed_launch(
                khi.data_ptr(), klo.data_ptr(), table[0].data_ptr(),
                table[1].data_ptr(), table[2].data_ptr(), oh.data_ptr(),
                ol.data_ptr(), khi.numel(), bits,
                torch.cuda.current_stream(dev).cuda_stream))
            return oh, ol
        fns = {"kernel": lambda i: rl_ops.ring_lookup_bucketed(khi, klo,
                                                               *table)}
        fns.update({what: (lambda i, lib=lib: alt(i, lib))
                    for what, lib in libs.items()})
        for what, fn in fns.items():
            got = fn(0)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K2 {what} {name} differs")
            row[f"{what}_{name}"] = {"ms": smoke.cuda_ms(fn),
                                     "device_ms": device_ms(fn)}
    # where the launcher's choice between its two routes should sit: each
    # route alone at batch sizes between the round's 32 keys and 2^16
    sweep = {}
    for n in K2_SWEEP:
        khi, klo = words(keys[:n], dev)
        for what in ("window_only", "warp_only"):
            sweep[f"{what}_{n}"] = device_ms(lambda i: alt(i, libs[what]))
    emit({"phase": "k2_alternatives", **row, "route_sweep_device_ms": sweep})


def build_dir_source(name: str, text: str) -> Path:
    from repro_torch.kernels import build
    path = build.BUILD_DIR / "steps" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_steps: no CUDA device is available",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import backend, build
    from repro_torch.kernels.decode_attention import kernel as dk
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.library()
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    k3_simt(dev, gen)
    k2(dev)
    if hasattr(dk, "chunk_positions"):   # the redesigned kernels
        k3_tc(dev, gen)
        k2_alternatives(dev)
    print(backend.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What holds K3 (decode attention), K2 (bucketed ring lookup), K6
(selective scan), K4 (EDRA tree), K7 (single-word ring lookup), K5b
(the flash backward) and K6b (the scan's backward) back, and what each step of their redesign buys, on
one card; and K5's (flash attention) device time at the serve paths'
heads.

    python3 chip_kernel_steps.py [phase ...]     # all phases by default

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
            2^16, by device time, which places the launcher's choice;
  k6        K6 at (1, L, 8192, 16), bf16 x/B/C/D, f32 dt/A, for L 128, 512
            and 1024 (a falcon-mamba-7b admit's prompts): the kernel and
            each timing variant of its design (``K6_STEPS``: patched copies
            of ``csrc/ssm_scan.cu``; the PR 13 design's precise ``expf`` to
            ``exp2f``, no h.C reduction, staging tiles of 16-128 positions;
            the PR 17 design's ``expf``, 8 positions a segment with 4
            states interleaved, 2 or 4 states interleaved, one tile in
            shared memory instead of two, 16 segments of 8 positions a
            channel, and timing-only cuts: no exponentials, no state loop,
            no loads after the first tile, no scan, no h chain in the
            walk), with the plain version's errors beside (only the
            kernel is gated), the bound
            and the SFU's floor (``chip_smoke.sfu_ms``); first the launch's
            occupancy and registers (a probe built into the kernel's own
            translation unit);
  k4        K4 at 2^21 pairs on rings of 10^6 +- 400 (``chip_smoke``'s
            inputs) in its three variants: the kernel, the same pairs
            sorted by popcount, and each timing variant of its design
            (``K4_STEPS``; the PR 12 design's modulo as a subtraction,
            ``__logf``, grid caps; the PR 17 design's unsorted tiles, the
            modulo at every hop, ``__logf``, grids of 1 to 64 waves of
            resident blocks), integers and ack bits against the plain
            version (only the kernel is gated); first the launch shape;
  k7        K7 on the sorted high words of the 10^6 peer ids, Q 2^20 and
            the quickstart's Q 4096, and timing cuts: all keys equal (every
            probe an L1 hit), a 4096-word table, and each timing variant of
            its design (``K7_STEPS``; the first design's search cut 10 levels
            early); then Q 256 to 2^20 on each route the launcher has,
            which places its crossover; each case against numpy's bisect
            (only the kernel is gated); first the launch shape;
  k5        K5 (``ops.flash_attention``) on a 1024-token causal
            whole-prompt admit in bf16 at the heads of qwen2.5-3b (16 / 2,
            hd 128), qwen3-moe-235b-a22b (64 / 4, hd 128), zamba2-7b's
            shared block (32 / 32, hd 112) and deepseek-v2's MLA (128 /
            128, q . k 192, v 128), by device time (torch.profiler)
            and by the CUDA-event time of back-to-back calls, beside SDPA's
            device time (its default backend) on the same inputs; a shape
            the tree's tensor-core route does not take is reported as
            skipped;
  k5b       K5b (``flash_attention_bwd_cuda``, bf16, causal) at the
            training shapes of qwen2.5-3b (B 8, S 1024, 16 / 2, hd 128),
            lm-100m (B 8, S 256, 12 / 4, hd 64) and deepseek-v2 (B 1,
            S 2048, 128 / 128, q . k 192, v 128): the device ms of each of
            its three kernels and in all, the CUDA-event ms, and the error
            against the plain version, for the kernel and for each timing
            variant of its design (``K5B_STEPS``: patched copies of
            ``csrc/flash_attention_bwd.cu``), with the number of functions
            in which ptxas serialized the wgmmas (its C7515 note);
  k6b       K6b (``ssm_scan_bwd_cuda``, bf16 x/B/C/D/dy, f32 dt/A, no h0
            or dh_last; the second design fed K6's tile start states) at
            falcon-mamba-7b's training shape (B 8, L 1024, Din 8192, N 16)
            and at B 1: the device ms of its scan kernel and of its sums
            across blocks (clusters), and in all, the CUDA-event ms, K6's
            forward at the same shape beside it (with and without the
            states), the bound and the SFU's floor (``chip_smoke.k6b_bound``,
            ``sfu_ms``), and at B 1 the error against the plain version
            (the plain version walks every position in turn); then each
            timing variant of the tree's design (``K6B_STEPS``: patched
            copies of ``csrc/ssm_scan_bwd.cu``, built in parallel; the PR
            27 design's cuts: no pass 1, pass 1 without its exponential,
            no dB / dC flush, no channel join; the second design's cuts and
            shapes: no loads after the first tile, no block sums, no
            cluster sums, no B / C loads, no exponentials, no scans, no
            channel join, no per-group barrier, and one state or four at
            once, two blocks an SM, 48 channels a block, a channel's
            segments on neighbouring lanes), each with its error at B 1
            (only the
            kernel is gated); first the launch's occupancy, registers and
            ptxas report (a probe built into the kernel's own translation
            unit).

The phases read which design the checkout holds from its sources, so the
script also measures a parent's kernels when copied into its tree.

Then nvidia-smi's name and power limit as the last line.  Imports no jax.
"""
from __future__ import annotations

import contextlib
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
    int64_t q, int bits, int64_t warp_keys, void* stream) {
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
    int64_t q, int bits, int64_t warp_keys, void* stream) {
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


def variant_library(name: str, src: Path, swaps=None, extra: str = ""):
    """One CUDA source built into build/steps/, with its entry points typed
    as ``build.SIGNATURES`` types them.  ``swaps`` maps lines of the source
    to their replacements: the variant is a patched copy, and each line
    must be found once.  ``extra`` is appended to the patched copy (a probe
    that reads the kernel's launch attributes in the same translation
    unit)."""
    from repro_torch.kernels import build
    if swaps or extra:
        text = src.read_text()
        for old, new in (swaps or {}).items():
            if text.count(old) != 1:
                raise AssertionError(f"{src.name}: {old!r} not found once")
            text = text.replace(old, new)
        src = build_dir_source(f"{name}.cu", text + extra)
    out = build.BUILD_DIR / "steps" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                           f"-I{build.CSRC}", "-o", str(out), str(src)],
                          check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.build_log = proc.stdout + proc.stderr          # ptxas' -v report
    for entry, argtypes in build.SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def checked(code: int) -> None:
    if code:
        raise RuntimeError(f"CUDA error {code}")


@contextlib.contextmanager
def routed_to(lib):
    """The wrappers' launches go to ``lib`` (a variant library) inside the
    block: ``build.launch`` is looked up at each call."""
    from repro_torch.kernels import build
    saved = build.launch
    build.launch = lambda name, *args: checked(getattr(lib, name)(*args))
    try:
        yield
    finally:
        build.launch = saved


def probe(lib, *args) -> list:
    """The ``steps_probe`` entry a variant library was built with: eight
    ints of launch attributes (see the probe sources below)."""
    out = (ctypes.c_int * 8)()
    lib.steps_probe.argtypes = [ctypes.c_int] * len(args) \
        + [ctypes.POINTER(ctypes.c_int)]
    checked(lib.steps_probe(*args, out))
    return list(out)


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
    libs = {"bisect": variant_library(
                "k2_bisect", build_dir_source("k2_bisect.cu", K2_BISECT_CU)),
            "lanes8": variant_library(
                "k2_lanes8", build_dir_source("k2_lanes8.cu", K2_LANES8_CU)),
            "window16": variant_library(
                "k2_window16", src, {window: "constexpr int kWindow = 16;"}),
            "window_only": build.library(),    # the launch's warp_keys 0
            "warp_only": build.library()}      # and 2^62: one route each
    warp_keys = {"window_only": 0, "warp_only": 1 << 62}
    bits = table[0].shape[0].bit_length() - 1
    row = {}
    for name, ks in k2_cases(keys).items():
        khi, klo = words(ks, dev)
        want = ring_lookup_bucketed_ref(khi, klo, *table)

        def alt(i, lib, wk=4096):
            oh, ol = torch.empty_like(khi), torch.empty_like(klo)
            checked(lib.ring_lookup_bucketed_launch(
                khi.data_ptr(), klo.data_ptr(), table[0].data_ptr(),
                table[1].data_ptr(), table[2].data_ptr(), oh.data_ptr(),
                ol.data_ptr(), khi.numel(), bits, wk,
                torch.cuda.current_stream(dev).cuda_stream))
            return oh, ol
        fns = {"kernel": lambda i: rl_ops.ring_lookup_bucketed(khi, klo,
                                                               *table)}
        fns.update({what: (lambda i, lib=lib, wk=warp_keys.get(what, 4096):
                           alt(i, lib, wk))
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
            sweep[f"{what}_{n}"] = device_ms(
                lambda i: alt(i, libs[what], warp_keys[what]))
    emit({"phase": "k2_alternatives", **row, "route_sweep_device_ms": sweep})


def build_dir_source(name: str, text: str) -> Path:
    from repro_torch.kernels import build
    path = build.BUILD_DIR / "steps" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


# -- K6 (selective scan) and K4 (EDRA tree) ---------------------------------

K6_LENGTHS = (128, 512, 1024)     # falcon-mamba-7b admits' prompt lengths
# timing variants of each design of csrc/ssm_scan.cu (patched copies), and
# a probe of its launch appended to the kernel's own translation unit:
# out = (blocks an SM, registers, dynamic smem bytes, threads a block,
# channels a block, positions a tile, local-memory bytes, blocks a row)
K6_STEPS = {
    # PR 13: a thread a (channel, state), P lanes a channel, y by shuffles
    "pr13": ({
        "exp2f": {
            "const float a = live ? A[static_cast<size_t>(ch) * N + s] : 0.f;":
            "const float a = live ? A[static_cast<size_t>(ch) * N + s] * "
            "1.4426950408889634f : 0.f;",
            "const float da = expf(__fmul_rn(dtt, a));":
            "const float da = exp2f(__fmul_rn(dtt, a));"},
        "no_reduction": {"for (int off = P >> 1; off > 0; off >>= 1)":
                         "for (int off = 0; off > 0; off >>= 1)"},
        **{f"kt{k}": {"int kt = 64;": f"int kt = {k};"} for k in (16, 32, 128)},
    }, r"""
extern "C" int steps_probe(int n, int din, int* out) {
  int P = 1;
  while (P < n) P <<= 1;
  const int cpb = kThreads / P;
  int kt = 64;
  while (kt > 1 && smem_floats(kt, cpb, n) * sizeof(float) > kSmemBudget) kt >>= 1;
  const int smem = static_cast<int>(smem_floats(kt, cpb, n) * sizeof(float));
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ssm_scan_kernel<__nv_bfloat16>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], ssm_scan_kernel<__nv_bfloat16>, kThreads, smem);
  out[1] = attr.numRegs; out[2] = smem; out[3] = kThreads; out[4] = cpb;
  out[5] = kt; out[6] = static_cast<int>(attr.localSizeBytes);
  out[7] = (din + cpb - 1) / cpb;
  return static_cast<int>(e);
}
"""),
    # PR 17: a thread a (channel, segment of kItems positions), the states
    # looped in the thread, segments joined by a scan of (decay, h) pairs
    "pr17": ({
        "expf": {'  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));':
                 "  y = exp2f(x);"},
        "items8_group4": {"constexpr int kItems = 16;":
                          "constexpr int kItems = 8;",
                          "constexpr int kStateGroup = 1;":
                          "constexpr int kStateGroup = 4;"},
        **{f"group{k}": {"constexpr int kStateGroup = 1;":
                         f"constexpr int kStateGroup = {k};"} for k in (2, 4)},
        "one_stage": {"constexpr int kStages = 2;": "constexpr int kStages = 1;"},
        "segs16": {
            "constexpr int kSegs = 8;": "constexpr int kSegs = 16;",
            "constexpr int kChannels = 32;": "constexpr int kChannels = 16;",
            "constexpr int kItems = 16;": "constexpr int kItems = 8;",
            "constexpr int kMinBlocks = 2;": "constexpr int kMinBlocks = 3;"},
        # timing only: no exponentials, the loads and stores alone, the
        # maths alone, no scan, no h chain in the walk
        "no_exp": {'  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));':
                   "  y = 1.0f + x;"},
        "no_states": {"    for (int n0 = 0; n0 < npad; n0 += kStateGroup) {":
                      "    for (int n0 = 0; n0 < 0; n0 += kStateGroup) {"},
        "no_loads": {"    if (t0 + kTile < L) fetch(t0 + kTile, st ^ 1);":
                     "    if (false) fetch(t0 + kTile, st ^ 1);"},
        "no_scan": {"      for (int dd = 1; dd < kSegs; dd <<= 1) {":
                    "      for (int dd = kSegs; dd < kSegs; dd <<= 1) {"},
        "walk_no_chain": {"            h = fmaf(da[g][i], h, u[g][i]);":
                          "            h = u[g][i];"},
    }, r"""
extern "C" int steps_probe(int n, int din, int* out) {
  const int smem = static_cast<int>(smem_bytes<__nv_bfloat16>(n));
  cudaFuncAttributes attr;
  cudaError_t e = prepare<__nv_bfloat16>(smem);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, ssm_scan_kernel<__nv_bfloat16>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], ssm_scan_kernel<__nv_bfloat16>, kThreads, smem);
  out[1] = attr.numRegs; out[2] = smem; out[3] = kThreads; out[4] = kChannels;
  out[5] = kTile; out[6] = static_cast<int>(attr.localSizeBytes);
  out[7] = (din + kChannels - 1) / kChannels;
  return static_cast<int>(e);
}
"""),
}


def design(src: Path, marker: str, new: str, old: str) -> str:
    return new if marker in src.read_text() else old


def k6(dev, gen):
    """K6 at (1, L, 8192, 16) for the admit's prompt lengths: the kernel,
    then each timing variant of its design, by CUDA-event and device time,
    each beside the plain version's errors (variants are not gated); the
    launch's occupancy first."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    src = build.CSRC / "ssm_scan.cu"
    which = design(src, "kItems", "pr17", "pr13")
    swaps, probe_src = K6_STEPS[which]
    libs = {"kernel": variant_library(f"k6_{which}", src, extra=probe_src)}
    libs.update({name: variant_library(f"k6_{which}_{name}", src, sw)
                 for name, sw in swaps.items()})
    _, _, din, n = smoke.K6_SHAPE
    occ = probe(libs["kernel"], n, din)
    emit({"phase": "k6_launch", "design": which, "blocks_per_sm": occ[0],
          "registers": occ[1], "smem_bytes": occ[2], "threads": occ[3],
          "channels_per_block": occ[4], "tile_positions": occ[5],
          "local_bytes": occ[6], "blocks": occ[7],
          "sms": torch.cuda.get_device_properties(dev).multi_processor_count})
    for l in K6_LENGTHS:
        x, dt, B, C, A, D, h0 = smoke.k6_random_inputs(dev, gen,
                                                       (1, l, din, n))
        x, B, C, D = (t.bfloat16() for t in (x, B, C, D))
        args = (x, dt, B, C, A, D, h0)
        wy, wh = ssm_scan_ref(*args)
        b6, by6, _ = smoke.k6_bound(*args)
        row = {"L": l, "exponentials": l * din * n, "bound_ms": b6,
               "bound_by": by6, "sfu_ms": smoke.sfu_ms(l * din * n)}
        for name, lib in libs.items():
            with routed_to(lib):
                y, h = sk.ssm_scan_cuda(*args)
                torch.cuda.synchronize()
                fn = lambda i: sk.ssm_scan_cuda(*args)  # noqa: E731
                row[name] = {
                    "ms": smoke.cuda_ms(fn), "device_ms": device_ms(fn),
                    "h_err": float((h - wh).abs().max()),
                    "y_err": float((y.float() - wy.float()).abs().max())}
        gate = row["kernel"]
        if not (gate["h_err"] <= smoke.K6_ATOL and gate["y_err"]
                <= smoke.K6_Y_REL * float(wy.float().abs().max())):
            raise AssertionError(f"K6 L={l}: {gate}")
        emit({"phase": "k6", "design": which, **row})
        del x, dt, B, C, A, D, h0, wy, wh
        torch.cuda.empty_cache()


K4_STEPS = {
    # PR 12: every level tested in turn, the modulo at every hop
    "pr12": ({
        "mod_subtract": {"const uint32_t sender = (rep + cur) % n;":
                         "uint32_t sender = rep + cur; "
                         "if (sender >= n) sender -= n;"},
        "fast_log": {"const float dly = __fmul_rn(-logf(u01(h)), c.delta);":
                     "const float dly = __fmul_rn(-__logf(u01(h)), c.delta);"},
        "grid_132x8": {"constexpr int64_t kMaxBlocks = 132 * 16;":
                       "constexpr int64_t kMaxBlocks = 132 * 8;"},
        "grid_a_pair_a_thread": {"constexpr int64_t kMaxBlocks = 132 * 16;":
                                 "constexpr int64_t kMaxBlocks = INT64_MAX;"},
    }, r"""
extern "C" int steps_probe(int variant, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, edra_tree_kernel<kEarlyClose>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], edra_tree_kernel<kEarlyClose>, kThreads, 0);
  out[1] = attr.numRegs; out[2] = 0; out[3] = kThreads;
  out[4] = static_cast<int>(kMaxBlocks); out[6] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
"""),
    # PR 17: set bits only, pairs sorted by hops in a tile, one modulo
    "pr17": ({
        "no_tile_sort": {"constexpr bool kSortTile = true;":
                         "constexpr bool kSortTile = false;"},
        "modulo_a_hop": {"constexpr bool kOneModulo = true;":
                         "constexpr bool kOneModulo = false;"},
        "fast_log": {"const float dly = __fmul_rn(-logf(u01(h)), c.delta);":
                     "const float dly = __fmul_rn(-__logf(u01(h)), c.delta);"},
    }, r"""
extern "C" int steps_probe(int variant, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, edra_tree_kernel<kEarlyClose>);
  if (e == cudaSuccess) e = blocks_per_sm(kEarlyClose, &out[0]);
  out[1] = attr.numRegs; out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = out[0] * sm_count(); out[6] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
"""),
}


def popcount_order(offset):
    """The permutation that sorts (P,) int32 offsets by popcount."""
    import torch
    x = offset.cpu().numpy().view(np.uint32).astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x55555555))
    x = (x & np.uint64(0x33333333)) + ((x >> np.uint64(2))
                                       & np.uint64(0x33333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    pc = ((x * np.uint64(0x01010101)) & np.uint64(0xFFFFFFFF)) >> np.uint64(24)
    return torch.from_numpy(np.argsort(pc, kind="stable")).to(offset.device)


def k4(dev):
    """K4 at 2^21 pairs on rings of 10^6 +- 400 (``chip_smoke.k4_inputs``)
    in its three variants: the kernel, the same pairs sorted by popcount
    (what divergence costs), and each timing variant of its design, by
    CUDA-event and device time, with integers and ack bits against the
    plain version (variants are not gated); the launch shape first."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.edra_tree import kernel as ek
    from repro_torch.kernels.edra_tree.ref import tree_math
    src = build.CSRC / "edra_tree.cu"
    which = design(src, "kSortTile", "pr17", "pr12")
    swaps, probe_src = K4_STEPS[which]
    libs = {"kernel": variant_library(f"k4_{which}", src, extra=probe_src)}
    libs.update({name: variant_library(f"k4_{which}_{name}", src, sw)
                 for name, sw in swaps.items()})
    occ = probe(libs["kernel"], 2)
    emit({"phase": "k4_launch", "design": which, "blocks_per_sm": occ[0],
          "registers": occ[1], "smem_bytes": occ[2], "threads": occ[3],
          "grid_cap": occ[4], "local_bytes": occ[6],
          "sms": torch.cuda.get_device_properties(dev).multi_processor_count})
    for i, (vname, kw) in enumerate(smoke.k4_variants().items()):
        args = smoke.k4_inputs(dev, seed=smoke.SEED + i)
        want = tree_math(*args, **kw)
        order = popcount_order(args[0])
        cases = {name: (lib, args, want, None) for name, lib in libs.items()}
        cases["sorted_pairs"] = (libs["kernel"],
                                 tuple(a[order] for a in args),
                                 tuple(w[order] for w in want), None)
        if which == "pr17":       # the grid, an argument of edra_tree_launch
            cases.update({f"grid_waves{k}": (libs["kernel"], args, want,
                                             {"grid_waves": k})
                          for k in (1, 2, 64)})
        row = {"variant": vname, "pairs": int(args[0].numel()),
               "hops": int(want[2].sum())}
        for name, (lib, a, w, tiles) in cases.items():
            with routed_to(lib):
                got = ek.edra_tree_cuda(*a, tiles=tiles, **kw)
                torch.cuda.synchronize()
                fn = lambda j: ek.edra_tree_cuda(*a, tiles=tiles,  # noqa: E731
                                                 **kw)
                row[name] = {
                    "ms": smoke.cuda_ms(fn), "device_ms": device_ms(fn),
                    "integers_equal": all(torch.equal(g, x) for g, x in
                                          zip(got[1:], w[1:])),
                    "ack_not_bit_equal": int((got[0].view(torch.int32)
                                              != w[0].view(torch.int32)).sum())}
        gate = row["kernel"]
        if not gate["integers_equal"] or gate["ack_not_bit_equal"]:
            raise AssertionError(f"K4 {vname}: {gate}")
        emit({"phase": "k4", "design": which, **row})
        del args, want, cases
        torch.cuda.empty_cache()


# -- K7 (single-word ring lookup) ---------------------------------------------

K7_SWEEP = (256, 1024, 4096, 16384, 65536, 1 << 17, 1 << 18, 1 << 20)
# lines of the redesign's source that its timing variants replace
K7_COPY = """  {
    constexpr int kCopies = (kK7Sample + 1) / 4 / kK7Threads;
    const uint4* src = reinterpret_cast<const uint4*>(compact);
    uint4 v[kCopies];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) v[j] = src[threadIdx.x + j * kK7Threads];
#pragma unroll
    for (int j = 0; j < kCopies; ++j) tree4[threadIdx.x + j * kK7Threads] = v[j];
  }
"""
K7_BELOW = "  const auto below = [&](int32_t j) { return table[j] < key; };\n"
K7_SECOND_WINDOWS = (
    "    w0 -= kK7Window;                   // the aligned window before it "
    "(>= 0:\n"
    "    wn = kK7Window;                    // w0 > lo + 1 >= 1, a multiple)\n"
    "    in = window_below<kVec>(table, wn, key, w0);\n",
    "    w0 += kK7Window;                   // the aligned window after it "
    "(wn was\n"
    "    wn = min(kK7Window, n - w0);       // kK7Window, so w0 + wn < hi <= "
    "N)\n"
    "    in = window_below<kVec>(table, wn, key, w0);\n")
K7_STEPS = {
    # the first design: a thread a key, one branchless lower bound over
    # the N words
    "one_level": ({
        # timing only: the search stops 10 levels early (a segment of
        # ~1024 words is left unsearched), so only the top levels' L1 hits
        # and ~10 dependent probes are paid
        "cut_last10": {"  while (len > 1) {": "  while (len > 1024) {"},
    }, r"""
extern "C" int steps_probe(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ring_lookup32_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], ring_lookup32_kernel, kThreads, 0);
  out[1] = attr.numRegs; out[2] = 0; out[3] = kThreads;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
"""),
    # the redesign: a shared-memory sample tree, an interpolated window,
    # one level at small Q (``k7`` also runs the kernel pinned to each
    # route, ``route_one_level`` and ``route_sampled``)
    "sample_tree": ({
        # each block gathers the tree from the table at stride s itself
        # (no tree kernel, no compact scratch)
        "fill_strided": {
            K7_COPY: "  for (int32_t k = threadIdx.x; k <= kK7Sample; "
                     "k += blockDim.x)\n"
                     "    reinterpret_cast<uint32_t*>(tree4)[k] = "
                     "tree_node(table, k, ((n - 1) >> shift) + 1, shift);\n",
            "  ring_lookup32_tree_kernel<<<(kK7Sample + 256) / 256, 256, 0, "
            "st>>>(t, samp, m, shift);\n": ""},
        # the segment's lower bound straight after the tree (no window)
        "no_window": {K7_BELOW: K7_BELOW + "  if (n > 0)   // always\n"
                      "    return lo + 1 + count_below(hi - lo - 1, [&]"
                      "(int32_t j) { return below(lo + 1 + j); });\n"},
        # the lower bound where the first window misses (no neighbour)
        "one_window": {line: "" for line in K7_SECOND_WINDOWS},
        "window16": {"constexpr int kK7Window = 8;":
                     "constexpr int kK7Window = 16;"},
        "sample8191": {"constexpr int kK7Levels = 15;":
                       "constexpr int kK7Levels = 13;",
                       "constexpr int kK7Sample = 32767;":
                       "constexpr int kK7Sample = 8191;"},
    }, r"""
extern "C" int steps_probe(int n, int* out) {
  int shift = 0;
  while ((static_cast<int64_t>(kK7Sample) << shift) < n) ++shift;
  const int m = ((n - 1) >> shift) + 1;
  const int smem = (kK7Sample + 1) * static_cast<int>(sizeof(uint32_t));
  cudaFuncAttributes attr;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = k7_prepare<true>(device);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, ring_lookup32_sampled_kernel<true>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], ring_lookup32_sampled_kernel<true>, kK7Threads, smem);
  out[1] = attr.numRegs; out[2] = smem; out[3] = kK7Threads;
  out[4] = 1 << shift; out[5] = m; out[6] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(e);
}
"""),
}


def k7_inputs():
    """K7's table, the sorted high words of chip_smoke's 10^6 peer ids
    (duplicates kept), and its 2^20 keys from the same numpy seeds."""
    rng = np.random.default_rng(smoke.SEED)
    ids = np.unique(rng.integers(0, 2**64, size=smoke.N_PEERS + 4096,
                                 dtype=np.uint64))
    ids = ids[rng.permutation(ids.size)[:smoke.N_PEERS]]
    table = np.sort((ids >> np.uint64(32)).astype(np.uint32))
    keys = np.random.default_rng(smoke.SEED + 7).integers(
        0, 2**32, smoke.K7_KEYS, dtype=np.uint32)
    return table, keys


def k7(dev):
    """K7 at Q 2^20 on the 10^6 ids' high words and at the quickstart's Q
    4096, then timing cuts: all keys equal (every probe an L1 hit), a
    table of 4096 words, and each timing variant of the design
    (``K7_STEPS``), by CUDA-event and device time, each against numpy's
    bisect (only the kernel is gated); then Q from 256 to 2^20 on each
    route the design has (the redesign's kernel pinned to each route,
    ``route_one_level`` and ``route_sampled``), which places the
    wrapper's crossover.  The launch shape first."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ring_lookup import kernel as rk
    src = build.CSRC / "ring_lookup.cu"
    which = design(src, "ring_lookup_sampled_launch", "sample_tree",
                   "one_level")
    swaps, probe_src = K7_STEPS[which]
    libs = {"kernel": variant_library(f"k7_{which}", src, extra=probe_src)}
    libs.update({name: variant_library(f"k7_{which}_{name}", src, sw)
                 for name, sw in swaps.items()})
    # name -> (library, route handed to the launcher; None: the wrapper's)
    runs = {name: (lib, None) for name, lib in libs.items()}
    if which == "sample_tree":
        runs.update({f"route_{r}": (libs["kernel"], r) for r in rk.K7_ROUTES})

    def call(kt, tt, route):
        return rk.ring_lookup_cuda(kt, tt, *(() if route is None
                                             else (route,)))
    table, keys = k7_inputs()
    occ = probe(libs["kernel"],
                *((table.size,) if which == "sample_tree" else ()))
    emit({"phase": "k7_launch", "design": which, "blocks_per_sm": occ[0],
          "registers": occ[1], "smem_bytes": occ[2], "threads": occ[3],
          "stride": occ[4], "samples": occ[5], "local_bytes": occ[6],
          "sms": torch.cuda.get_device_properties(dev).multi_processor_count})
    small = np.sort(table[::table.size // 4096][:4096])
    cases = {"q2^20": (keys, table, 0), "q4096": (keys[:4096], table, 0),
             "equal_keys_q2^20": (np.full(keys.size, keys[0]), table, 0),
             "table4096_q2^20": (keys, small, 0),
             "table_off_by_4_bytes_q2^20": (keys, table, 1)}

    def words(a, offset=0):
        buf = np.zeros(a.size + offset, np.uint32)
        buf[offset:] = a
        return torch.from_numpy(buf.view(np.int32)).to(dev)[offset:]
    for case, (ks, tb, offset) in cases.items():
        kt, tt = words(ks), words(tb, offset)
        want = np.searchsorted(tb, ks, side="left") % tb.size
        row = {"case": case, "Q": int(ks.size), "N": int(tb.size)}
        for name, (lib, route) in runs.items():
            with routed_to(lib):
                got = call(kt, tt, route)
                torch.cuda.synchronize()
                fn = lambda i: call(kt, tt, route)  # noqa: E731
                row[name] = {"ms": smoke.cuda_ms(fn),
                             "device_ms": device_ms(fn),
                             "equal": bool(np.array_equal(got.cpu().numpy(),
                                                          want))}
        if not row["kernel"]["equal"]:
            raise AssertionError(f"K7 {case}: differs from numpy's bisect")
        emit({"phase": "k7", "design": which, **row})
    routes = {name: run for name, run in runs.items()
              if name == "kernel" or name.startswith("route_")}
    tt = words(table)
    for q in K7_SWEEP:
        kt = words(keys[:q])
        row = {"Q": q}
        for name, (lib, route) in routes.items():
            with routed_to(lib):
                row[name] = device_ms(
                    lambda i: call(kt, tt, route))  # noqa: B023
        emit({"phase": "k7_sweep", "design": which, **row})


K5_HEADS = {"qwen2.5-3b": (16, 2, 128), "qwen3-moe": (64, 4, 128),
            "zamba2-7b": (32, 32, 112),
            "deepseek-v2": (128, 128, 192, 128)}   # MLA: q . k 192, v 128
K5_TOL = 2e-2                     # repro's bf16 tolerance (test_kernels.py)


def k5(dev, gen):
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    s = 1024
    for model, heads in K5_HEADS.items():
        h, hkv, hd = heads[:3]
        dv = heads[3] if len(heads) > 3 else hd
        row = {"model": model, "B": 1, "S": s, "H": h, "Hkv": hkv, "hd": hd,
               "dv": dv, "dtype": "bfloat16", "causal": True}
        try:    # a parent tree's route takes no v head dim
            tc = (fk.route(torch.bfloat16, hd, dv) if dv != hd
                  else fk.route(torch.bfloat16, hd)) == "tc"
        except TypeError:
            tc = False
        if not tc:
            emit({"phase": "k5", **row, "skipped": "not on this tree's "
                  "tensor-core route"})
            continue
        q, k, v = (torch.randn((1, s, n, d), generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for n, d in ((h, hd), (hkv, hd), (hkv, dv)))
        fn = fa_ops.flash_attention
        before = fn.tc_launches
        got = fn(q, k, v, causal=True)
        torch.cuda.synchronize()
        if fn.tc_launches != before + 1:
            raise AssertionError(f"K5 at {model}'s heads left the tensor cores")
        err = float((got.float() - flash_attention_ref(
            q, k, v, causal=True).float()).abs().max())
        if not err <= K5_TOL:
            raise AssertionError(f"K5 at {model}'s heads: err {err}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa(i):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        kernel = lambda i: fn(q, k, v, causal=True)  # noqa: E731
        row.update(err=err, device_ms=device_ms(kernel),
                   ms=smoke.cuda_ms(kernel), sdpa_device_ms=device_ms(sdpa))
        emit({"phase": "k5", **row})
        del q, k, v, qt, kt, vt, got
    torch.cuda.empty_cache()


# K5b at the training paths' shapes: (model, B, S, H, Hkv, q . k hd, v hd)
K5B_SHAPES = (("qwen2.5-3b", 8, 1024, 16, 2, 128, 128),
              ("lm-100m", 8, 256, 12, 4, 64, 64),
              ("deepseek-v2", 1, 2048, 128, 128, 192, 128))
# timing variants of the wgmma design of csrc/flash_attention_bwd.cu
# (patched copies): the zeroed dK/dV and dQ sums not pinned before the
# first wgmma (ptxas then serializes the products), rings of two stages
# everywhere, and a stage refilled only once the step's first products
# are done (wait for all, then refill)
K5B_PIN = """  // ptxas serializes the products)
#pragma unroll
  for (int bx = 0; bx < NQK; ++bx) fence_regs(dq_acc[bx]);
"""
K5B_PIN2 = """  // ptxas serializes the products)
#pragma unroll
  for (int bx = 0; bx < NQK; ++bx) fence_regs(dk_acc[bx]);
#pragma unroll
  for (int bx = 0; bx < NV; ++bx) fence_regs(dv_acc[bx]);
"""
K5B_STEPS = {
    "unpinned": {K5B_PIN: "", K5B_PIN2: ""},
    "stages2": {"dkdv_smem(3) <= kSmemMax ? 3 : 2": "2",
                "2 * (dq_smem(3) + 1024) <= kSmemSm ? 3 : 2": "2"},
    "late_refill": {
        """    wg_wait<1>();
    bar_sync(1 + wg, kWg);
    if (t == 0 && m >= 1 && m - 1 + kStages < n_mine) load(m - 1 + kStages);
    wg_wait<0>();""": """    wg_wait<0>();
    bar_sync(1 + wg, kWg);
    if (t == 0 && m >= 1 && m - 1 + kStages < n_mine) load(m - 1 + kStages);""",
        """    wg_wait<1>();
    __syncthreads();
    if (tid == 0 && j >= 1 && j - 1 + kStages < n_kt) load(j - 1 + kStages);
    wg_wait<0>();""": """    wg_wait<0>();
    __syncthreads();
    if (tid == 0 && j >= 1 && j - 1 + kStages < n_kt) load(j - 1 + kStages);"""},
}
K5B_TOL = 2e-2                    # chip_smoke's bf16 K5B_TOL (of max |ref|)


def k5b(dev, gen):
    """K5b's kernels by device time at the training shapes, for the kernel
    and each timing variant of its design (variants are not gated)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    src = build.CSRC / "flash_attention_bwd.cu"
    if "bwd_dkdv_wgmma_kernel" not in src.read_text():
        emit({"phase": "k5b", "skipped": "not the wgmma design"})
        return
    libs = {"kernel": variant_library("k5b_kernel", src)}
    libs.update({name: variant_library(f"k5b_{name}", src, sw)
                 for name, sw in K5B_STEPS.items()})
    for model, b, s, h, hkv, hd, hv in K5B_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.bfloat16)
                       for shape in ((b, s, h, hd), (b, s, hkv, hd),
                                     (b, s, hkv, hv), (b, s, h, hv)))
        o, lse = fk.flash_attention_cuda(q, k, v, causal=True, with_lse=True)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
        row = {"model": model, "B": b, "S": s, "H": h, "Hkv": hkv, "hd": hd,
               "dv": hv, "dtype": "bfloat16", "causal": True}
        for name, lib in libs.items():
            def call(i):
                return fk.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                   causal=True)
            with routed_to(lib):
                got = call(0)
                torch.cuda.synchronize()
                err = max(float((x.float() - w.float()).abs().max()
                                / w.float().abs().max())
                          for x, w in zip(got, want))
                if name == "kernel" and not err <= K5B_TOL:
                    raise AssertionError(f"K5b at {model}'s shape: {err}")
                per_kernel = profile_split(call)
                emit({"phase": "k5b", **row, "variant": name, "rel_err": err,
                      "device_ms": device_ms(call), "ms": smoke.cuda_ms(call),
                      "per_kernel_device_ms": per_kernel,
                      "serialized_functions": lib.build_log.count("C7515")})
            del got
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()


# timing variants of each design of csrc/ssm_scan_bwd.cu (patched copies,
# timing only: their gradients are not gated), and a probe of the scan
# kernel's launch appended to its own translation unit: out = (blocks an
# SM, registers, dynamic smem bytes, threads a block, channels a block,
# positions a tile, local-memory bytes, blocks a cluster)
K6B_STEPS = {
    # the first design: pass 1 the tiles' start states, pass 2 the reverse scan; dB /
    # dC through per-block partials.  The cuts: no pass 1 (pass 2 starts
    # from whatever the scratch holds), pass 1 without its exponential
    # (the second a state), no dB / dC flush (no block sums, partial
    # writes or their two barriers), no channel join (no butterfly)
    "two_pass": ({
        "no_pass1": {"  for (int tile = 0; tile < tiles; ++tile) {":
                     "  for (int tile = 0; tile < 0; ++tile) {"},
        "no_second_exp": {
            "          H = fmaf(decay(dtv[i] * a2), H, dtx[i] * bs[k]);":
            "          H = fmaf(dtv[i] * a2, H, dtx[i] * bs[k]);"},
        "no_flush": {
            "      __syncthreads();\n      // the block's dB and dC of these "
            "states: the warps' sums in order\n      const int ns = "
            "min(kRedStates, N - n0);": "      const int ns = 0;",
            "        part_c[at] = sc;\n      }\n      __syncthreads();\n":
            "        part_c[at] = sc;\n      }\n"},
        "no_join": {"        join_channels(db, ob, lane);\n"
                    "        join_channels(dc, oc, lane);":
                    "        ob[0] = db[0], ob[1] = db[1], oc[0] = dc[0], "
                    "oc[1] = dc[1];"},
    }, r"""
extern "C" int steps_probe(int n, int din, int* out) {
  const int smem = static_cast<int>(smem_bytes(n));
  cudaFuncAttributes attr;
  cudaError_t e = prepare<__nv_bfloat16>(smem);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, ssm_scan_bwd_kernel<__nv_bfloat16>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], ssm_scan_bwd_kernel<__nv_bfloat16>, kThreads, smem);
  out[1] = attr.numRegs; out[2] = smem; out[3] = kThreads; out[4] = kChannels;
  out[5] = kTile; out[6] = static_cast<int>(attr.localSizeBytes); out[7] = 1;
  return static_cast<int>(e);
}
"""),
    # the second design: tiles started from K6's states, one exponential a (position,
    # channel, state), 16-position segments, the next tile's loads during
    # this one, dB / dC summed in clusters of 8 blocks.  The cuts: no
    # loads after the first tile, no block sums of the warps' dB / dC, no
    # sums across the cluster (no distributed shared memory reads)
    "tile_states": ({
        "no_loads": {"      if (tile > 0) fetch(tile - 1);":
                     "      if (false) fetch(tile - 1);"},
        "no_block_sums": {"          if (tt < rows && n0 + g < N) {":
                          "          if (false) {"},
        "no_cluster_sums": {
            "    for (int e = tid; e < 2 * kSlice * N; e += kThreads) {":
            "    for (int e = tid; e < 0; e += kThreads) {"},
        "no_bc_loads": {"          const float4 v = src[g][c][q4];":
                        "          const float4 v = make_float4(float(g), float(c), "
                        "float(q4), 1.f);"},
        "segment_lanes": {"constexpr int kSegLane = 4; ": "constexpr int kSegLane = 1; ",
                          "constexpr int kChLane = 1; ": "constexpr int kChLane = 8; "},
        "no_exp": {'  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));':
                   "  y = 1.0f + x;"},
        "no_scans": {
            "            const float Pp = __shfl_up_sync(0xffffffffu, Pc[g], dd * kSegLane);":
            "            const float Pp = 1.f;",
            "            const float Hp = __shfl_up_sync(0xffffffffu, H[g], dd * kSegLane);":
            "            const float Hp = 0.f;",
            "            const float Pn = __shfl_down_sync(0xffffffffu, Pc[g], dd * kSegLane);":
            "            const float Pn = 1.f;",
            "            const float Qn = __shfl_down_sync(0xffffffffu, Q[g], dd * kSegLane);":
            "            const float Qn = 0.f;"},
        "no_join": {"__shfl_xor_sync(0xffffffffu, gb[1], kChLane)": "gb[1]",
                    "__shfl_xor_sync(0xffffffffu, gc[1], kChLane)": "gc[1]",
                    "__shfl_xor_sync(0xffffffffu, sb, 2 * kChLane)": "sb",
                    "__shfl_xor_sync(0xffffffffu, sc, 2 * kChLane)": "sc"},
        "state_barrier_cut": {
            "        __syncthreads();\n        if (pending) {":
            "        if (pending) {"},
        # other shapes of the design: one state at a time, four, two
        # blocks an SM (registers capped at 128), 48 channels a block
        "group1": {"constexpr int kGroup = 2;": "constexpr int kGroup = 1;"},
        "group4": {"constexpr int kGroup = 2;": "constexpr int kGroup = 4;"},
        "two_blocks_group1": {"constexpr int kMinBlocks = 1;":
                              "constexpr int kMinBlocks = 2;",
                              "constexpr int kGroup = 2;":
                              "constexpr int kGroup = 1;"},
        "ch48_group1": {"constexpr int kChannels = 32;":
                        "constexpr int kChannels = 48;",
                        "constexpr int kGroup = 2;": "constexpr int kGroup = 1;"},
    }, r"""
extern "C" int steps_probe(int n, int din, int* out) {
  int occ[6];
  const int e = occupancy<__nv_bfloat16>(n, occ);
  out[0] = occ[0]; out[1] = occ[2]; out[2] = occ[4]; out[3] = occ[5];
  out[4] = kChannels; out[5] = kTile; out[6] = occ[3]; out[7] = kCluster;
  return e;
}
"""),
}


def k6b(dev, gen):
    """K6b at falcon-mamba-7b's training shape and at B 1: its kernels'
    device time, K6's beside it, the bound and the SFU's floor; then, at
    the training shape, each timing variant of its design by device time
    (variants are not gated); the launch's occupancy first."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    src = build.CSRC / "ssm_scan_bwd.cu"
    which = design(src, "map_shared_rank", "tile_states", "two_pass")
    swaps, probe_src = K6B_STEPS[which]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=8) as pool:   # one nvcc a variant
        built = {name: pool.submit(variant_library, f"k6b_{which}_{name}",
                                   src, sw) for name, sw in swaps.items()}
        built["kernel"] = pool.submit(variant_library, f"k6b_{which}", src,
                                      extra=probe_src)
    libs = {"kernel": built.pop("kernel").result()}
    for name, f in built.items():        # a variant that does not build: say so
        try:
            libs[name] = f.result()
        except subprocess.CalledProcessError as e:
            emit({"phase": "k6b_variant", "variant": name,
                  "build_error": (e.stdout or "")[-2000:] + (e.stderr or "")[-2000:]})
    _, l, din, n = smoke.K6B_SHAPE
    occ = probe(libs["kernel"], n, din)
    emit({"phase": "k6b_launch", "design": which, "blocks_per_sm": occ[0],
          "warps_per_sm": occ[0] * occ[3] // 32, "registers": occ[1],
          "smem_bytes": occ[2], "threads": occ[3],
          "channels_per_block": occ[4], "tile_positions": occ[5],
          "local_bytes": occ[6], "cluster_blocks": occ[7],
          "ptxas": [ln.strip() for ln in libs["kernel"].build_log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]})
    for bb in (smoke.K6B_SHAPE[0], 1):
        x, dt, B, C, A, D, _ = smoke.k6_random_inputs(dev, gen,
                                                      (bb, l, din, n))
        x, B, C, D = (t.bfloat16() for t in (x, B, C, D))
        dy = torch.randn((bb, l, din), generator=gen, device=dev).bfloat16()
        args = (x, dt, B, C, A, D, None, dy, None)
        if which == "tile_states":
            states = sk.ssm_scan_cuda(*args[:7], states=True)[2]
            fn = lambda i: sk.ssm_scan_bwd_cuda(*args, states)  # noqa: E731
        else:
            fn = lambda i: sk.ssm_scan_bwd_cuda(*args)  # noqa: E731
        b6b, by6b, _ = smoke.k6b_bound(*args)
        row = {"shape": [bb, l, din, n], "design": which,
               "k6_forward_device_ms": device_ms(
                   lambda i: sk.ssm_scan_cuda(*args[:7])),
               "bound_ms": b6b, "bound_by": by6b,
               "sfu_ms": smoke.sfu_ms(bb * l * din * n)}
        if which == "tile_states":
            row["k6_forward_with_states_device_ms"] = device_ms(
                lambda i: sk.ssm_scan_cuda(*args[:7], states=True))
        want = ssm_scan_bwd_ref(*args) if bb == 1 else None
        for name, lib in libs.items():
            with routed_to(lib):
                split = {k: float(np.median(v))
                         for k, v in _by_kernel(fn).items()}
                out = {"device_ms": sum(split.values()),
                       "device_ms_by_kernel": split}
                if name == "kernel":
                    out["ms"] = smoke.cuda_ms(fn, iters=10)
                if want is not None:
                    got = fn(0)
                    out["max_rel_err"] = max(smoke.rel_err(g, w)
                                             for g, w in zip(got, want)
                                             if w is not None)
                    del got
            row[name] = out
        emit({"phase": "k6b", **row})
        del x, dt, B, C, A, D, dy, args, want
        torch.cuda.empty_cache()


def _by_kernel(fn, windows=3):
    """Each kernel's device ms per call of ``fn`` over ``windows``
    profiled windows."""
    out = {}
    for _ in range(windows):
        for k, v in profile_split(fn).items():
            out.setdefault(k, []).append(v)
    return out


PHASES = ("k3_simt", "k2", "k3_tc", "k2_alternatives", "k6", "k4", "k7", "k5",
          "k5b", "k6b")


def main(argv=None) -> int:
    import torch
    phases = list(argv if argv is not None else sys.argv[1:]) or list(PHASES)
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        print(f"chip_kernel_steps: unknown phases {unknown}; takes "
              f"{list(PHASES)}", file=sys.stderr)
        return 2
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
    redesigned = hasattr(dk, "chunk_positions")   # K3 and K2 of PR 16 on
    for phase in PHASES:
        if phase not in phases:
            continue
        if phase in ("k3_tc", "k2_alternatives") and not redesigned:
            continue
        if phase == "k6b" and not (build.CSRC / "ssm_scan_bwd.cu").exists():
            continue                      # a tree from before K6b
        if phase in ("k3_simt", "k3_tc", "k6", "k5", "k5b", "k6b"):
            globals()[phase](dev, gen)
        else:
            globals()[phase](dev)
    print(backend.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

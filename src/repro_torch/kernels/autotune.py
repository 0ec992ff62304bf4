"""Launch-shape autotuning of the port's CUDA kernels (the counterpart of
``repro.kernels.autotune``).

A small search-and-cache layer over each launcher's run-time launch
shape, under ``repro``'s six kernel keys:

  ``ring_lookup``           K1 ``ring_lookup64``: the grid cap in blocks
                            an SM (``kK1BlocksPerSM``, an argument of
                            ``ring_lookup64_launch``); K7: the Q up to
                            which it takes the one-level route
                            (``K7_SAMPLE_KEYS``).  The two share the key
                            and are told apart by the dim ``words`` (2
                            for K1's 64-bit ids, 1 for K7's words).
  ``ring_lookup_bucketed``  K2: the Q up to which it takes a warp a key
                            (``kK2WarpKeys``, an argument of
                            ``ring_lookup_bucketed_launch``).
  ``edra_tree``             K4: the grid in waves of resident blocks
                            (``kGridWaves``, an argument of
                            ``edra_tree_launch``).
  ``decode_attention``      K3: the tensor-core route's ``chunk`` and the
                            SIMT route's ``splits``, 0 meaning the
                            launcher's heuristic (``chunk_positions`` /
                            ``num_splits``), which is the default.
  ``flash_attention``       K5: one candidate, ``bm = bn = 64``: the
                            wgmma warpgroup and the TMA boxes fix the
                            tile (``kBM``/``kBN``), so nothing is
                            searched.
  ``ssm_scan``              K6: one candidate, ``channels = 32``: the
                            shared-memory tile layout fixes it
                            (``kChannels``).

What is tuned is the launch shape, never the tensor-core tiles the
kernels are compiled with, so a candidate changes how the work is cut
up and not what is computed: K1, K2, K4 and K7 give the same bits at
every candidate, and K3 the same values within its tolerance.

  * **Keying**: an entry is keyed on the device (its name, compute
    capability and the digest of ``csrc/`` that ``kernels/build.py``
    builds from), the kernel and a shape bucket that rounds every dim up
    to a power of two.  An entry written for another card or another
    build of the sources is never read.
  * **Persistence**: winners live in the JSON file that
    ``$REPRO_TORCH_AUTOTUNE_CACHE`` names, read once a process and kept
    in memory; it is re-read only after this process writes it.  With
    the variable unset there is no file: every launch takes the
    defaults, and a search refuses to run.  So a launch shape other
    than the shipped one is only ever one that the caller asked for.  A
    missing, corrupt or wrong-version file, or an entry that is not one
    of the candidates, gives the defaults: it can never take a kernel
    down.
  * **CPU tensors** get the defaults at once, with no file I/O: the
    kernels run their plain versions there.

Resolution (``tiles_for``) never searches.  Searching happens only
through ``autotune_kernel`` / ``autotune_all``, on the card: each valid
candidate is launched, held against the default's output and the plain
version (a difference is a fault and raises), and timed on the device
(``device_readings``); a candidate the launcher refuses is a loss, and
the default stays unless a candidate beats it by more than the spread of
the default's own readings.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1

# The launch shapes each kernel shipped with: the CPU's answer and the
# safety net for a missing or corrupt cache.  0 in ``decode_attention``
# is the launcher's heuristic.
DEFAULTS: Dict[str, Dict[str, int]] = {
    "ring_lookup": {"blocks_per_sm": 1, "sample_keys": 65536},
    "ring_lookup_bucketed": {"warp_keys": 4096},
    "edra_tree": {"grid_waves": 4},
    "decode_attention": {"chunk": 0, "splits": 0},
    "flash_attention": {"bm": 64, "bn": 64},
    "ssm_scan": {"channels": 32},
}

_K7_SWITCH = (1024, 16384, 65536, 262144, 1 << 22)
_K2_SWITCH = (0, 1024, 4096, 16384, 65536, 1 << 21)
_K3_CHUNKS = (512, 256, 128, 64)       # decode_attention.kernel.CHUNKS
_K3_SPLITS = (1, 2, 4, 8, 16, 32)

# Sweep space per kernel.  K1 and K7 candidates move one knob each (the
# other at its default); K7's and K2's switches reach past both sides of
# the sweep's Q, so each sweep point races both routes.
CANDIDATES: Dict[str, List[Dict[str, int]]] = {
    "ring_lookup": [{"blocks_per_sm": b, "sample_keys": 65536}
                    for b in (1, 2, 4)]
    + [{"blocks_per_sm": 1, "sample_keys": s} for s in _K7_SWITCH
       if s != 65536],
    "ring_lookup_bucketed": [{"warp_keys": w} for w in _K2_SWITCH],
    "edra_tree": [{"grid_waves": g} for g in (1, 2, 4, 8)],
    "decode_attention": [{"chunk": 0, "splits": 0}]
    + [{"chunk": c, "splits": 0} for c in _K3_CHUNKS]
    + [{"chunk": 0, "splits": s} for s in _K3_SPLITS],
    "flash_attention": [{"bm": 64, "bn": 64}],
    "ssm_scan": [{"channels": 32}],
}

KERNELS = tuple(DEFAULTS)

# process-level record of how launch shapes were resolved (provenance)
_resolutions: set = set()
_memory: Dict[str, dict] = {}          # cache path -> its parsed file
_resolved: Dict[tuple, Dict[str, int]] = {}   # (kernel, device, dims) -> tiles
_device_keys: Dict[int, str] = {}


class AutotuneFault(AssertionError):
    """A candidate launched but computed something else than the default
    or the plain version, or could not be timed on the device: a fault,
    never a loss."""


def cache_path() -> Optional[str]:
    """The cache file ``$REPRO_TORCH_AUTOTUNE_CACHE`` names, or None."""
    return os.environ.get(CACHE_ENV) or None


def reset() -> None:
    """Forget the cache file read and the resolutions of this process (the
    next ``tiles_for`` reads ``cache_path()`` anew)."""
    _memory.clear()
    _resolved.clear()
    _resolutions.clear()


def _on_card(device) -> bool:          # indirection so tests can monkeypatch
    return device is not None and device.type == "cuda"


def _device_key(device) -> str:
    """``name/smXY/digest``: the card, its compute capability and the
    digest of the kernels' sources."""
    device = torch.device(device)
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = _device_keys.get(idx)
    if key is None:
        from .build import source_digest
        major, minor = torch.cuda.get_device_capability(idx)
        key = _device_keys[idx] = (f"{torch.cuda.get_device_name(idx)}/"
                                   f"sm{major}{minor}/{source_digest()}")
    return key


def shape_bucket(**dims: int) -> str:
    """Canonical shape-class key: every dim rounded up to a power of two
    (0/1 stay as-is), fields sorted for stability."""
    parts = []
    for k in sorted(dims):
        v = int(dims[k])
        if v > 1:
            v = 1 << (v - 1).bit_length()
        parts.append(f"{k}{v}")
    return "_".join(parts)


def _entry_key(device, kernel: str, bucket: str) -> str:
    return f"{_device_key(device)}/{kernel}/{bucket}"


def load_cache(path: Optional[str] = None) -> dict:
    """Parsed cache file; no file, or a missing, corrupt, or
    wrong-version one, reads as empty (defaults win) instead of
    raising."""
    path = path or cache_path()
    if path is None:
        return {"version": CACHE_VERSION, "entries": {}}
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) \
                or data.get("version") != CACHE_VERSION \
                or not isinstance(data.get("entries"), dict):
            return {"version": CACHE_VERSION, "entries": {}}
        return data
    except (OSError, ValueError):
        return {"version": CACHE_VERSION, "entries": {}}


def _save_cache(data: dict, path: Optional[str] = None) -> None:
    path = path or cache_path()
    if path is None:
        raise ValueError(f"no cache file: set {CACHE_ENV}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic-ish: never leave a torn file for a concurrent reader
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".autotune-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _memory.pop(path, None)            # this process re-reads what it wrote
    _resolved.clear()


def _cached(path: str) -> dict:
    data = _memory.get(path)
    if data is None:
        data = _memory[path] = load_cache(path)
    return data


# ---------------------------------------------------------------------------
# Per-kernel candidate validity
# ---------------------------------------------------------------------------

def _tiles_valid(kernel: str, tiles: Dict[str, int],
                 dims: Dict[str, int]) -> bool:
    """Is ``tiles`` one of the kernel's candidates for a call of ``dims``?"""
    if tiles not in CANDIDATES[kernel]:
        return False
    base = DEFAULTS[kernel]
    if kernel == "ring_lookup":        # K1 moves its grid cap, K7 its switch
        fixed = "sample_keys" if dims.get("words", 1) == 2 \
            else "blocks_per_sm"
        return tiles[fixed] == base[fixed]
    if kernel == "decode_attention":
        if dims.get("tc", 1):
            return tiles["splits"] == 0
        return tiles["chunk"] == 0 and \
            tiles["splits"] <= max(1, -(-dims.get("s", 1) // 32))
    return True


def candidates_for(kernel: str, dims: Dict[str, int]) -> List[Dict[str, int]]:
    return [dict(c) for c in CANDIDATES[kernel]
            if _tiles_valid(kernel, c, dims)]


# ---------------------------------------------------------------------------
# Resolution (cache/defaults only, never a search)
# ---------------------------------------------------------------------------

def tiles_for(kernel: str, device=None, **dims: int) -> Dict[str, int]:
    """Launch shape of one call of ``kernel`` on ``device``.

    CPU tensors (and ``device=None``) get the defaults at once, with no
    file I/O, and so does the card when ``cache_path()`` is None.  On
    the card the cache, read once a process, is consulted
    for this (device, kernel, shape bucket); a miss, an entry that is not
    a valid candidate for ``dims``, or a corrupt file gives the
    defaults.  After the first call with the same dims it is a dict
    lookup.  The returned dict is the caller's to keep (a copy)."""
    if isinstance(device, str):
        device = torch.device(device)
    path = cache_path() if _on_card(device) else None
    if path is None:
        _resolutions.add("defaults")
        return dict(DEFAULTS[kernel])
    memo = (kernel, device, tuple(dims.items()))
    tiles = _resolved.get(memo)
    if tiles is None:
        tiles, how = dict(DEFAULTS[kernel]), "defaults"
        entry = _cached(path)["entries"].get(
            _entry_key(device, kernel, shape_bucket(**dims)))
        if isinstance(entry, dict) and isinstance(entry.get("tiles"), dict):
            try:
                got = {k: int(v) for k, v in entry["tiles"].items()}
            except (TypeError, ValueError):
                got = None
            if got is not None and _tiles_valid(kernel, got, dims):
                tiles, how = got, "cache"
        _resolutions.add(how)
        if len(_resolved) > 4096:      # a bounded memo of call shapes
            _resolved.clear()
        _resolved[memo] = tiles
    return dict(tiles)


def status_label() -> str:
    """How launch shapes were resolved so far this process (provenance):
    ``defaults`` (CPU / no cache hits), ``cache`` (every resolution hit
    the cache), ``searched`` (a search ran) or ``mixed``."""
    if not _resolutions or _resolutions == {"defaults"}:
        return "defaults"
    if "searched" in _resolutions:
        return "searched"
    if _resolutions == {"cache"}:
        return "cache"
    return "mixed"


# ---------------------------------------------------------------------------
# Search (host-level only: called by chip_smoke.py and by hand)
# ---------------------------------------------------------------------------

def device_readings(fn: Callable[[], object], reps: int = 7,
                    iters: int = 10) -> List[float]:
    """``reps`` readings of the device ms of one call of ``fn``, after a
    warm-up call.  Each reading is the CUDA-event mean of ``iters``
    back-to-back calls queued behind a spin kernel
    (``torch.cuda._sleep``) that lasts longer than the host takes to
    queue them: the calls then run one after another on the device, and
    the events time the device, not the host's launch cost.  A spin too
    short for that is doubled and the reading taken again; a host that
    cannot get ahead at all raises ``AutotuneFault``."""
    fn()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles, readings = 1 << 20, []
    while len(readings) < reps:
        t0 = time.perf_counter()
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        for _ in range(iters):
            fn()
        marks[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].synchronize()
        if marks[0].elapsed_time(marks[1]) > host_ms:
            readings.append(marks[1].elapsed_time(marks[2]) / iters)
        elif cycles < 1 << 31:
            cycles *= 2
        else:
            raise AutotuneFault(f"the host took {host_ms:.3f} ms to queue "
                                f"{iters} calls: longer than any spin")
    return readings


def _median_spread(readings) -> Tuple[float, float]:
    """A bench's answer, a time or a list of readings of one, as (median,
    max - min)."""
    if isinstance(readings, (int, float)):
        return float(readings), 0.0
    xs = sorted(float(x) for x in readings)
    return xs[len(xs) // 2], xs[-1] - xs[0]


class _Case:
    """One kernel at one shape on the card: ``call(tiles)`` launches the
    kernel at a launch shape (through its ``kernel.py`` launcher, so no
    ``ops`` counter moves), ``plain()`` runs its plain version on the same
    inputs, ``same(got, want)`` holds two outputs to the kernel's rule."""

    def __init__(self, call, plain, tol: float = 0.0):
        self.call, self.plain, self.tol = call, plain, tol

    def diff(self, got, want) -> float:
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        if self.tol == 0.0:
            return 0.0 if all(torch.equal(g, w) for g, w in zip(got, want)) \
                else float("inf")
        return max(float((g.float() - w.float()).abs().max())
                   for g, w in zip(got, want))


def _words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their uint32 bit patterns in int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _id_words(ids, dev):
    """(Q,) uint64 numpy ids -> their (hi, lo) words as int32 tensors."""
    import numpy as np
    return tuple(torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)
                 for w in (ids >> np.uint64(32), ids & np.uint64(2**32 - 1)))


def _ring(peers: int, dev):
    """A ``RingState`` of ``peers`` random ids (seed 0) on ``dev``."""
    import numpy as np
    from ..core.ringstate import RingState
    rng = np.random.default_rng(0)
    ids = np.unique(rng.integers(0, 2**64, peers, dtype=np.uint64))
    return RingState(ids, device=dev), rng


def _make_case(kernel: str, dims: Dict[str, int], dev) -> _Case:
    """Inputs of the requested shape on ``dev``, made from seed 0."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(0)
    if kernel == "ring_lookup" and dims.get("words", 1) == 2:
        # a ring of n peers (the launcher keys on the table's capacity,
        # the least power of two >= n: the same bucket)
        from .ring_lookup.kernel import ring_lookup64_cuda
        from .ring_lookup.ref import ring_lookup64_ref
        state, rng = _ring(dims["n"], dev)
        thi, tlo, n = state.device_table()
        khi, klo = _id_words(rng.integers(0, 2**64, dims["q"],
                                          dtype=np.uint64), dev)
        return _Case(lambda t: ring_lookup64_cuda(khi, klo, thi, tlo, n,
                                                  tiles=t),
                     lambda: ring_lookup64_ref(khi, klo, thi, tlo, n))
    if kernel == "ring_lookup":
        from .ring_lookup.kernel import ring_lookup_cuda
        from .ring_lookup.ref import ring_lookup_ref
        table = _words(torch.sort(torch.randint(
            0, 2**32, (dims["n"],), generator=gen, device=dev,
            dtype=torch.int64)).values)
        keys = _words(torch.randint(0, 2**32, (dims["q"],), generator=gen,
                                    device=dev, dtype=torch.int64))
        return _Case(lambda t: ring_lookup_cuda(keys, table, tiles=t),
                     lambda: ring_lookup_ref(keys, table))
    if kernel == "ring_lookup_bucketed":
        # b buckets: the directory of a ring of b * 10^6 / 2^15 peers (a
        # 10^6-peer ring has 2^15 on an H100); half the keys are peer ids
        from .ring_lookup.kernel import ring_lookup_bucketed_cuda
        from .ring_lookup.ref import ring_lookup_bucketed_ref
        state, rng = _ring(dims["b"] * 10**6 // 2**15, dev)
        table = state.device_bucket_table()
        if table is None or table[0].shape[0] != dims["b"]:
            raise ValueError(f"the ring's directory is not {dims['b']} "
                             f"buckets: {state.bucket_stats()}")
        act = state.active_ids()
        khi, klo = _id_words(np.concatenate([act[:dims["q"] // 2], rng.integers(
            0, 2**64, dims["q"] - dims["q"] // 2, dtype=np.uint64)]), dev)
        return _Case(lambda t: ring_lookup_bucketed_cuda(khi, klo, *table,
                                                         tiles=t),
                     lambda: ring_lookup_bucketed_ref(khi, klo, *table))
    if kernel == "edra_tree":
        from .edra_tree.kernel import edra_tree_cuda
        from .edra_tree.ref import tree_math
        p = dims["p"]
        ring = torch.randint(10**6 - 400, 10**6 + 400, (p,), generator=gen,
                             device=dev, dtype=torch.int64)
        u = torch.rand((3, p), generator=gen, device=dev, dtype=torch.float64)
        offset, rep = ((u[i] * ring).long().to(torch.int32) for i in (0, 1))
        key = _words(torch.randint(0, 2**32, (p,), generator=gen, device=dev,
                                   dtype=torch.int64))
        t0 = (u[2] * 600.0).to(torch.float32)
        n = ring.to(torch.int32)
        kw = dict(levels=20, theta=0.5, delta_avg=70e-6, seed=1)
        return _Case(lambda t: edra_tree_cuda(offset, n, rep, t0, key,
                                              tiles=t, **kw),
                     lambda: tree_math(offset, n, rep, t0, key, **kw))
    if kernel == "decode_attention":
        from .decode_attention.kernel import decode_attention_cuda
        from .decode_attention.ref import decode_attention_ref
        dtype = torch.bfloat16 if dims.get("tc", 1) else torch.float32
        b, s, h, hkv, hd = (dims[k] for k in ("b", "s", "h", "hkv", "hd"))
        q = torch.randn((b, h, hd), generator=gen, device=dev, dtype=dtype)
        k = torch.randn((b, s, hkv, hd), generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn((b, s, hkv, hd), generator=gen, device=dev,
                        dtype=dtype)
        length = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        return _Case(lambda t: decode_attention_cuda(q, k, v, length,
                                                     tiles=t),
                     lambda: decode_attention_ref(q, k, v, length),
                     tol=1.6e-2 if dtype == torch.bfloat16 else 2e-5)
    raise KeyError(f"no search case for {kernel!r}: it has one candidate")


def _default_bench(kernel: str, dims: Dict[str, int], device,
                   record: Optional[dict] = None
                   ) -> Callable[[dict], List[float]]:
    """``bench(tiles) -> readings`` (device ms) on inputs of ``dims``:
    each candidate is launched once and held against the default's
    output and the plain version (a difference raises
    ``AutotuneFault``), then timed by ``device_readings``."""
    case = _make_case(kernel, dims, device)
    want_plain = case.plain()
    want_default = case.call(dict(DEFAULTS[kernel]))
    base = case.diff(want_default, want_plain)
    if base > case.tol:
        raise AutotuneFault(f"{kernel} {dims}: the default launch differs "
                            f"from the plain version by {base}")

    def bench(tiles: dict) -> List[float]:
        got = case.call(tiles)     # a launch shape it refuses raises here
        err = max(case.diff(got, want_default), case.diff(got, want_plain))
        if err > case.tol:
            raise AutotuneFault(f"{kernel} {dims} at {tiles}: output differs "
                                f"from the default's or the plain version's "
                                f"by {err} (tolerance {case.tol})")
        try:
            readings = device_readings(lambda: case.call(tiles))
        except AutotuneFault:
            raise
        except Exception as e:     # it launched once: timing must work
            raise AutotuneFault(f"{kernel} {dims} at {tiles}: timing "
                                f"failed: {e!r}") from e
        if record is not None:
            ms, spread = _median_spread(readings)
            record.setdefault("candidates", []).append(
                {"tiles": dict(tiles), "ms": ms, "spread_ms": spread,
                 "max_abs_err_vs_plain": case.diff(got, want_plain)})
        return readings

    return bench


def autotune_kernel(kernel: str, dims: Dict[str, int], *,
                    bench: Optional[Callable[[dict], object]] = None,
                    force: bool = False, path: Optional[str] = None,
                    device=None, record: Optional[dict] = None
                    ) -> Dict[str, int]:
    """Search the candidates for one (kernel, shape bucket) on ``device``
    (default: the current CUDA device) and persist the winner to ``path``
    (default ``cache_path()``; a search with neither raises
    ``ValueError``).  A cache hit returns without searching unless
    ``force``; on the CPU the defaults come back untouched.
    ``bench(tiles)`` returns a time or a list of readings of one; the
    least median wins, but the default stays unless that median is below
    the default's by more than the spread (max - min) of the default's
    readings.  A candidate ``bench`` raises on is a loss, except
    ``AutotuneFault``, which propagates.  ``record``, when given,
    receives each candidate's time, the default's, the winner and its
    ratio to the default."""
    if kernel not in DEFAULTS:
        raise KeyError(f"unknown kernel {kernel!r}")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, str):
        device = torch.device(device)
    if not _on_card(device):
        _resolutions.add("defaults")
        return dict(DEFAULTS[kernel])
    path = path or cache_path()
    if path is None:
        raise ValueError(f"a search writes its winners to a file: set "
                         f"{CACHE_ENV} or pass path=")
    key = _entry_key(device, kernel, shape_bucket(**dims))
    cache = load_cache(path)
    hit = cache["entries"].get(key)
    if hit and not force and isinstance(hit.get("tiles"), dict):
        tiles = {k: int(v) for k, v in hit["tiles"].items()}
        if _tiles_valid(kernel, tiles, dims):
            _resolutions.add("cache")
            if record is not None:
                record.update(cached=True, winner=tiles)
            return tiles
    cands = candidates_for(kernel, dims) or [dict(DEFAULTS[kernel])]
    if bench is None:
        bench = _default_bench(kernel, dims, device, record) \
            if len(cands) > 1 else (lambda t: 0.0)
    results: List[Tuple[float, float, Dict[str, int]]] = []
    for cand in cands:
        try:
            results.append((*_median_spread(bench(cand)), cand))
        except AutotuneFault:
            raise
        except Exception:        # a shape the launcher refuses is a loss
            continue
    if not results:
        _resolutions.add("defaults")
        return dict(DEFAULTS[kernel])
    best_t, _, best = min(results, key=lambda r: r[0])
    default = next((r for r in results if r[2] == DEFAULTS[kernel]), None)
    default_t = default[0] if default else None
    if default and best_t >= default[0] - default[1]:
        best_t, best = default[0], default[2]   # inside the default's noise
    cache["entries"][key] = {
        "tiles": best, "ms": best_t, "default_ms": default_t,
        "candidates": len(results), "torch": torch.__version__}
    _save_cache(cache, path)
    _resolutions.add("searched")
    if record is not None:
        record.update(cached=False, winner=dict(best), ms=best_t,
                      default_ms=default_t,
                      default_spread_ms=default[1] if default else None,
                      winner_over_default=(best_t / default_t
                                           if default_t else None))
    return dict(best)


# The port's operating points: K1 at 2^20 keys over a 10^6-peer ring, K2
# on its directory at fused rounds' 16 and 32 keys and at 2^20, K3 at
# qwen2.5-3b's decode round of 16 (and on the SIMT route in f32), K4 at
# 2^21 pairs, K7 at 4096 and 2^20 keys.  K5 and K6 have one candidate
# each: nothing to sweep.
SWEEP_DIMS: Dict[str, List[Dict[str, int]]] = {
    "ring_lookup": [{"q": 1 << 20, "n": 10**6, "words": 2},
                    {"q": 4096, "n": 10**6, "words": 1},
                    {"q": 1 << 20, "n": 10**6, "words": 1}],
    "ring_lookup_bucketed": [{"q": 16, "b": 1 << 15},
                             {"q": 32, "b": 1 << 15},
                             {"q": 1 << 20, "b": 1 << 15}],
    "edra_tree": [{"p": 1 << 21}],
    "decode_attention": [{"b": 16, "s": 2048, "h": 16, "hkv": 2, "hd": 128,
                          "tc": 1},
                         {"b": 16, "s": 2048, "h": 16, "hkv": 2, "hd": 128,
                          "tc": 0}],
}


def autotune_all(*, force: bool = False, budget_s: Optional[float] = None,
                 device=None, records: Optional[dict] = None
                 ) -> Dict[str, dict]:
    """Sweep every kernel's operating points (on the card; the defaults
    on the CPU).  ``budget_s`` bounds the wall time: no new search starts
    past it.  ``records``, when given, gets each point's ``record``."""
    t0 = time.perf_counter()
    out: Dict[str, dict] = {}
    for kernel, shapes in SWEEP_DIMS.items():
        for dims in shapes:
            if budget_s is not None \
                    and time.perf_counter() - t0 > budget_s:
                return out
            name = f"{kernel}/{shape_bucket(**dims)}"
            rec = {} if records is not None else None
            out[name] = autotune_kernel(kernel, dims, force=force,
                                        device=device, record=rec)
            if records is not None:
                records[name] = rec
    return out

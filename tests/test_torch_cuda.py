"""The port's kernels on the card (K1-K7), each held against its plain version,
and the rule that a CUDA tensor never reaches a plain version.  Tests
marked ``cuda`` skip without a card; this file imports no jax, so it
runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The unmarked tests run everywhere: entry points refuse to fall back to
the CPU on their own, and the kernel launchers refuse non-CUDA tensors.
"""
import numpy as np
import pytest
import torch

from repro_torch import quickstart
from repro_torch.configs import get_smoke_config
from repro_torch.core.churn import ChurnConfig
from repro_torch.core.ringstate import RingState
from repro_torch.core.sim import simulate_churn
from repro_torch.kernels.backend import strict_fp32
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.edra_tree import kernel as et_kernel
from repro_torch.kernels.edra_tree import ops as et_ops
from repro_torch.kernels.edra_tree import ref as et_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ring_lookup import kernel as rl_kernel
from repro_torch.kernels.ring_lookup import ops as rl_ops
from repro_torch.kernels.ring_lookup import ref as rl_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan import ref as ssm_ref
from repro_torch.models import Model
from repro_torch.runtime import Membership
from repro_torch.serve import Replica, Request

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

# bf16 output: kernel and plain version both compute in f32 and round
# once; 2 bf16 ulps at |out| < 2 is 2^-6
BF16_ATOL = 1.6e-2
F32_ATOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels are CUDA C++ for sm_90a")
    strict_fp32()
    return torch.device("cuda")


def _words(ids: np.ndarray, device):
    ids = np.asarray(ids, np.uint64)
    hi = (ids >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def _ring(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(0, 2**64, size=n + n // 8 + 8,
                                 dtype=np.uint64))[:n]
    one = np.uint64(1)
    keys = np.concatenate([rng.integers(0, 2**64, size=4096, dtype=np.uint64),
                           ids, ids + one, ids - one,
                           np.array([0, 2**64 - 1], np.uint64)])
    return ids, keys


@pytest.mark.cuda
# K1 samples every s-th of the n live entries, s the least power of two
# with n <= s * 4096: n below, at and just above the sample size, n not a
# multiple of s (12_345: s 4; 10^6: s 256), and a full table (n = the
# device capacity 2^20); the keys hold every id (so every sampled id),
# each id +- 1, 0 and 2^64 - 1
@pytest.mark.parametrize("n", [1, 3, 2048, 4095, 4096, 4097, 12_345, 100_000,
                               1_000_000, 1 << 20])
def test_ring_lookup64_kernel_equals_plain(cuda, n):
    ids, keys = _ring(n)
    state = RingState(ids, device=cuda)
    thi, tlo, live = state.device_table()
    assert n < 1 << 20 or thi.numel() == n
    khi, klo = _words(keys, cuda)
    before = rl_ops.ring_lookup64.launches
    got = rl_ops.ring_lookup64(khi, klo, thi, tlo, live)
    torch.cuda.synchronize()
    assert rl_ops.ring_lookup64.launches == before + 1
    want = rl_ref.ring_lookup64_ref(khi, klo, thi, tlo, live)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        ids[got.cpu().numpy()], ids[np.searchsorted(ids, keys) % ids.size])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 100_000])
def test_ring_lookup_bucketed_kernel_equals_plain(cuda, n):
    ids, keys = _ring(n, seed=1)
    state = RingState(ids, device=cuda)
    table = state.device_bucket_table()
    khi, klo = _words(keys, cuda)
    before = rl_ops.ring_lookup_bucketed.launches
    got = rl_ops.ring_lookup_bucketed(khi, klo, *table)
    torch.cuda.synchronize()
    assert rl_ops.ring_lookup_bucketed.launches == before + 1
    want = rl_ref.ring_lookup_bucketed_ref(khi, klo, *table)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(
        state.lookup(keys, use_buckets=True),
        ids[np.searchsorted(ids, keys) % ids.size])


def _crowded_ring(seed=0):
    """2048 peers over 64 buckets: bucket 0 holds 127 of them (one row at
    occ 127), bucket 1 none (occ 0), some ids share a high word, and the
    rest lie in buckets 2-63."""
    rng = np.random.default_rng(seed)
    top = np.uint64(58)
    crowded = rng.integers(0, 2**58, 127, dtype=np.uint64)
    crowded[:8] = (crowded[0] >> np.uint64(32) << np.uint64(32)) \
        + rng.integers(0, 2**32, 8, dtype=np.uint64)
    rest = rng.integers(2 << 58, 2**64, 2048 - 127, dtype=np.uint64)
    ids = np.unique(np.concatenate([crowded, rest]))
    assert ids.size == 2048 and int((ids >> top == 0).sum()) == 127
    one = np.uint64(1)
    keys = np.concatenate([rng.integers(0, 2**64, 4096, dtype=np.uint64),
                           ids, ids + one, ids - one,
                           np.array([1 << 58, 0, 2**64 - 1], np.uint64)])
    return ids, keys


def _bucketed_equals_plain_and_bisect(state, keys, cuda):
    table = state.device_bucket_table()
    khi, klo = _words(keys, cuda)
    before = rl_ops.ring_lookup_bucketed.launches
    got = rl_ops.ring_lookup_bucketed(khi, klo, *table)
    torch.cuda.synchronize()
    assert rl_ops.ring_lookup_bucketed.launches == before + 1
    want = rl_ref.ring_lookup_bucketed_ref(khi, klo, *table)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    act = state.active_ids()
    owners = (got[0].cpu().numpy().view(np.uint32).astype(np.uint64)
              << np.uint64(32)) | got[1].cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(owners,
                                  act[np.searchsorted(act, keys) % act.size])


@pytest.mark.cuda
def test_ring_lookup_bucketed_kernel_on_full_and_empty_rows(cuda):
    ids, keys = _crowded_ring()
    state = RingState(ids, device=cuda)
    state.device_bucket_table()
    stats = state.bucket_stats()
    assert stats["valid"] and stats["buckets"] == 64
    assert stats["max_occupancy"] == 127
    occ = state.device_bucket_table()[2].cpu().numpy()
    assert occ[0] == 127 and occ[1] == 0
    assert keys.size > 4096                # the window route, then the warps
    _bucketed_equals_plain_and_bisect(state, keys, cuda)
    _bucketed_equals_plain_and_bisect(state, np.concatenate(
        [keys[4096:4096 + 200], keys[-3:]]), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [32, 1 << 16])
def test_ring_lookup_bucketed_kernel_at_a_million_peers(cuda, q):
    """10^6 peers (2^15 buckets), 1000 of them quarantined: the fused
    round's 32 keys and a 2^16-key batch."""
    ids, _ = _ring(1_000_000, seed=3)
    state = RingState(ids, device=cuda)
    for pid in ids[::1000]:
        state.set_quarantined(int(pid), True)
    assert len(state) == ids.size - ids[::1000].size
    rng = np.random.default_rng(q)
    keys = np.concatenate([ids[::1000], ids[1::1000],
                           rng.integers(0, 2**64, q, dtype=np.uint64)])[:q]
    _bucketed_equals_plain_and_bisect(state, keys, cuda)
    assert state.bucket_stats()["buckets"] == 1 << 15


def _k7_case(n, dups, seed=0):
    """A sorted uint32 table of n words (the high words of random 64-bit
    ids, with runs of repeated words when ``dups``) and keys: random
    words, every entry and its neighbours, and both ends of the range."""
    rng = np.random.default_rng(seed)
    table = (rng.integers(0, 2**64, size=n, dtype=np.uint64)
             >> np.uint64(32)).astype(np.uint32)
    if dups:
        table[: n // 2] = np.repeat(table[: n // 8 + 1], 4)[: n // 2]
    table = np.sort(table)
    keys = np.concatenate([rng.integers(0, 2**32, size=65536, dtype=np.uint32),
                           table, table + 1, table - 1,
                           np.array([0, 2**32 - 1], np.uint32)]
                          ).astype(np.uint32)
    return table, keys


@pytest.mark.cuda
@pytest.mark.parametrize("n,dups", [(1, False), (7, False), (7, True),
                                    (1000, False), (4096, True),
                                    (1_000_000, True)])
def test_ring_lookup_kernel_equals_plain(cuda, n, dups):
    table, keys = _k7_case(n, dups)
    kt = torch.from_numpy(keys.view(np.int32)).to(cuda)
    tt = torch.from_numpy(table.view(np.int32)).to(cuda)
    before = rl_ops.ring_lookup.launches
    got = rl_ops.ring_lookup(kt, tt)
    torch.cuda.synchronize()
    assert rl_ops.ring_lookup.launches == before + 1
    assert torch.equal(got, rl_ref.ring_lookup_ref(kt, tt))
    np.testing.assert_array_equal(
        got.cpu().numpy(), np.searchsorted(table, keys, side="left") % n)


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["one_level", "sampled"])
@pytest.mark.parametrize("n", [1, 7, 32767, 32769, 1_000_000,
                               32 * 32768 + 1])
def test_ring_lookup_kernel_on_both_routes(cuda, n, side):
    """Q at the crossover (one level) and one past it (the shared-memory
    sample and window), on tables either side of the stride steps: the
    wrapper's route counter moves by one."""
    table, keys = _k7_case(n, dups=n > 7, seed=n)
    q = rl_kernel.K7_SAMPLE_KEYS + (side == "sampled")
    keys = np.random.default_rng(n).choice(keys, q)   # words, neighbours
    keys[-2:] = [0, 2**32 - 1]
    kt = torch.from_numpy(keys.view(np.int32)).to(cuda)
    tt = torch.from_numpy(table.view(np.int32)).to(cuda)
    fn = rl_ops.ring_lookup
    before = fn.one_level_launches, fn.sampled_launches
    got = fn(kt, tt)
    torch.cuda.synchronize()
    assert (fn.one_level_launches - before[0], fn.sampled_launches
            - before[1]) == ((1, 0) if side == "one_level" else (0, 1))
    assert torch.equal(got, rl_ref.ring_lookup_ref(kt, tt))
    np.testing.assert_array_equal(
        got.cpu().numpy(), np.searchsorted(table, keys, side="left") % n)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [1_000_003, 4099])
def test_ring_lookup_kernel_on_a_misaligned_table(cuda, offset, n):
    """A table view 4, 8 or 12 bytes past a 16-byte boundary takes plain
    loads into the same window (16-byte loads where aligned), and the
    last window is cut by N."""
    table, keys = _k7_case(n, dups=True, seed=offset)
    buf = torch.zeros(n + offset, dtype=torch.int32, device=cuda)
    buf[offset:] = torch.from_numpy(table.view(np.int32)).to(cuda)
    tt = buf[offset:]
    assert tt.data_ptr() % 16 == 4 * offset
    kt = torch.from_numpy(keys.view(np.int32)).to(cuda)
    got = rl_ops.ring_lookup(kt, tt)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), np.searchsorted(table, keys, side="left") % n)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["one_level", "sampled"])
@pytest.mark.parametrize("q", [1, 4096, 1 << 20])
def test_ring_lookup_kernel_pinned_to_a_route(cuda, q, route):
    """Either route at any Q when the launcher is handed it: the sampled
    route at Q 1 and 4096, one level at 2^20."""
    table, keys = _k7_case(1_000_000, dups=True, seed=q)
    keys = np.random.default_rng(q).choice(keys, q)
    kt = torch.from_numpy(keys.view(np.int32)).to(cuda)
    tt = torch.from_numpy(table.view(np.int32)).to(cuda)
    got = rl_kernel.ring_lookup_cuda(kt, tt, route)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), np.searchsorted(table, keys, side="left")
        % table.size)


@pytest.mark.cuda
def test_ring_lookup_kernel_refuses_what_it_does_not_take(cuda):
    words = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rl_kernel.ring_lookup_cuda(words, words.long())
    with pytest.raises(ValueError):
        rl_kernel.ring_lookup_cuda(words, words.view(2, 4))
    with pytest.raises(ValueError, match="route"):
        rl_kernel.ring_lookup_cuda(words, words, "bisect")
    with pytest.raises(LookupError, match="empty routing table"):
        rl_ops.ring_lookup(words, words[:0])
    assert rl_ops.ring_lookup(words[:0], words).shape == (0,)


@pytest.mark.cuda
def test_quickstart_on_the_card_matches_the_cpu(cuda):
    before = rl_ops.ring_lookup.launches
    card = quickstart.run(cuda, out=lambda line: None)
    assert rl_ops.ring_lookup.launches == before + 1
    host = quickstart.run("cpu", out=lambda line: None)
    assert torch.equal(card["idx"].cpu(), host["idx"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,hd,s", [
    (1, 16, 2, 128, 2048), (8, 16, 2, 128, 2000), (3, 4, 2, 16, 37),
    (2, 8, 8, 64, 300),
])
def test_decode_attention_kernel_equals_plain(cuda, dtype, b, h, hkv, hd, s):
    g = torch.Generator(device=cuda).manual_seed(b * s)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    length = torch.randint(1, s + 1, (b,), generator=g, device=cuda,
                           dtype=torch.int32)
    length[0] = 1
    before = da_ops.decode_attention.launches
    got = da_ops.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert da_ops.decode_attention.launches == before + 1
    want = da_ref.decode_attention_ref(q, k, v, length)
    assert got.dtype == dtype and got.shape == want.shape
    atol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [2048, 2000])
def test_decode_attention_full_house_on_the_tensor_cores(cuda, dtype, s):
    """A replica's 32 slots at qwen2.5-3b's heads, rows of length 0 and S
    among random ones: one launch, on the tensor-core route."""
    b, h, hkv, hd = 32, 16, 2, 128
    g = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    length = torch.randint(1, s + 1, (b,), generator=g, device=cuda,
                           dtype=torch.int32)
    length[:4] = torch.tensor([0, s, 1, 65], dtype=torch.int32)
    fn = da_ops.decode_attention
    before = fn.launches, fn.tc_launches, fn.simt_launches
    got = fn(q, k, v, length)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches, fn.simt_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    want = da_ref.decode_attention_ref(q, k, v, length)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_decode_attention_at_six_query_heads_a_kv_head(cuda, dtype):
    """internlm2-20b's heads (48 over 8 kv heads, g = 6, hd 128) at a
    decode bucket of 16, S 2048: one launch, on the tensor cores."""
    b, h, hkv, hd, s = 16, 48, 8, 128, 2048
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    length = torch.randint(1, s + 1, (b,), generator=g, device=cuda,
                           dtype=torch.int32)
    length[:3] = torch.tensor([1, s, 129], dtype=torch.int32)
    assert da_kernel.route(dtype, hd, h // hkv) == "tc"
    fn = da_ops.decode_attention
    before = fn.launches, fn.tc_launches
    got = fn(q, k, v, length)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (before[0] + 1, before[1] + 1)
    want = da_ref.decode_attention_ref(q, k, v, length)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("h,hkv,hd", [(32, 32, 112), (64, 4, 128)])
def test_decode_attention_at_the_hybrid_and_moe_heads(cuda, dtype, h, hkv,
                                                      hd):
    """zamba2-7b's shared block (32 / 32 heads: g 1, hd 112) and
    qwen3-moe-235b-a22b's attention (64 / 4 heads: g 16, hd 128) at a
    decode bucket of 16, S 2048: one launch, on the tensor cores."""
    b, s = 16, 2048
    g = torch.Generator(device=cuda).manual_seed(h * hd)
    q = torch.randn((b, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    length = torch.randint(1, s + 1, (b,), generator=g, device=cuda,
                           dtype=torch.int32)
    length[:3] = torch.tensor([1, s, 129], dtype=torch.int32)
    assert da_kernel.route(dtype, hd, h // hkv) == "tc"
    fn = da_ops.decode_attention
    before = fn.launches, fn.tc_launches
    got = fn(q, k, v, length)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches) == (before[0] + 1, before[1] + 1)
    want = da_ref.decode_attention_ref(q, k, v, length)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.cuda
def test_decode_attention_calls_in_a_row_reset_the_merge(cuda):
    """Calls at B 32, then 5, then 32 again share the merge's counters on
    one stream; each must leave them at 0 for the next."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    for b in (32, 5, 32, 1):
        q = torch.randn((b, 16, 128), generator=gen, device=cuda).bfloat16()
        k = torch.randn((b, 2048, 2, 128), generator=gen,
                        device=cuda).bfloat16()
        v = torch.randn((b, 2048, 2, 128), generator=gen,
                        device=cuda).bfloat16()
        length = torch.randint(1, 2049, (b,), generator=gen, device=cuda,
                               dtype=torch.int32)
        got = da_ops.decode_attention(q, k, v, length)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.float(), da_ref.decode_attention_ref(q, k, v, length).float(),
            atol=BF16_ATOL, rtol=0)
        stream = torch.cuda.current_stream(cuda).cuda_stream
        part, count = da_kernel.tc_scratch(q.device, stream, 1, 1)
        assert not count.any()


@pytest.mark.cuda
def test_misaligned_inputs_are_refused_before_a_launch(cuda):
    """K3's tensor-core route reads q, K and V with 16-byte cp.async and
    K2 its rows with 16-byte loads: a view one element in is refused."""
    buf = torch.randn(2 * 64 * 2 * 128 + 1, device=cuda).bfloat16()
    kv = buf[1:].view(2, 64, 2, 128)
    assert kv.is_contiguous() and kv.data_ptr() % 16
    q = torch.randn((2, 16, 128), device=cuda).bfloat16()
    length = torch.tensor([64, 3], dtype=torch.int32, device=cuda)
    before = da_ops.decode_attention.launches
    with pytest.raises(ValueError, match="16-byte-aligned"):
        da_ops.decode_attention(q, kv, kv, length)
    words = torch.zeros(2 * 128 + 1, dtype=torch.int32, device=cuda)
    rows = words[1:].view(2, 128)
    occ = torch.zeros(2, dtype=torch.int32, device=cuda)
    keys = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rl_ops.ring_lookup_bucketed(keys, keys, rows, rows, occ)
    assert da_ops.decode_attention.launches == before


@pytest.mark.cuda
def test_decode_attention_routes(cuda):
    """bf16 at hd 128 runs on the tensor cores, f32 on the SIMT kernels;
    the route is the kernel module's, picked before the launch."""
    fn = da_ops.decode_attention
    for dtype, hd, h, want in ((torch.bfloat16, 128, 16, "tc"),
                               (torch.float16, 64, 8, "tc"),
                               (torch.float32, 128, 16, "simt"),
                               (torch.bfloat16, 40, 4, "simt"),
                               (torch.bfloat16, 64, 34, "simt")):
        assert da_kernel.route(dtype, hd, h // 2) == want
        q = torch.randn((2, h, hd), device=cuda).to(dtype)
        kv = torch.randn((2, 96, 2, hd), device=cuda).to(dtype)
        length = torch.tensor([96, 50], dtype=torch.int32, device=cuda)
        before = fn.tc_launches, fn.simt_launches
        got = fn(q, kv, kv, length)
        assert (fn.tc_launches - before[0], fn.simt_launches - before[1]) \
            == ((1, 0) if want == "tc" else (0, 1))
        atol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
        torch.testing.assert_close(
            got.float(), da_ref.decode_attention_ref(q, kv, kv, length).float(),
            atol=atol, rtol=0)


@pytest.mark.cuda
def test_decode_attention_length_zero_is_mean_of_v(cuda):
    q = torch.randn((2, 4, 32), device=cuda)
    k = torch.randn((2, 40, 2, 32), device=cuda)
    v = torch.randn((2, 40, 2, 32), device=cuda)
    length = torch.tensor([0, 40], dtype=torch.int32, device=cuda)
    got = da_ops.decode_attention(q, k, v, length)
    mean_v = v[0].mean(dim=0).repeat_interleave(2, dim=0)     # (H, hd)
    torch.testing.assert_close(got[0], mean_v, atol=F32_ATOL, rtol=0)
    torch.testing.assert_close(got, da_ref.decode_attention_ref(q, k, v, length),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.cuda
def test_decode_attention_length_zero_on_the_tensor_cores(cuda):
    """bf16: a row of length 0 gives the mean of V, merged over chunks."""
    q = torch.randn((2, 16, 128), device=cuda).bfloat16()
    k = torch.randn((2, 700, 2, 128), device=cuda).bfloat16()
    v = torch.randn((2, 700, 2, 128), device=cuda).bfloat16()
    length = torch.tensor([0, 700], dtype=torch.int32, device=cuda)
    before = da_ops.decode_attention.tc_launches
    got = da_ops.decode_attention(q, k, v, length).float()
    assert da_ops.decode_attention.tc_launches == before + 1
    mean_v = v[0].float().mean(dim=0).repeat_interleave(8, dim=0)  # (H, hd)
    torch.testing.assert_close(got[0], mean_v, atol=BF16_ATOL, rtol=0)
    torch.testing.assert_close(
        got, da_ref.decode_attention_ref(q, k, v, length).float(),
        atol=BF16_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(rl_ops, "ring_lookup_ref", refuse)
    monkeypatch.setattr(rl_ops, "ring_lookup64_ref", refuse)
    monkeypatch.setattr(rl_ops, "ring_lookup_bucketed_ref", refuse)
    monkeypatch.setattr(da_ops, "decode_attention_ref", refuse)
    monkeypatch.setattr(et_ops, "tree_math", refuse)
    monkeypatch.setattr(fa_ops, "flash_attention_ref", refuse)
    monkeypatch.setattr(ssm_ops, "ssm_scan_ref", refuse)
    ids, keys = _ring(3000, seed=2)
    state = RingState(ids, device=cuda)
    want = ids[np.searchsorted(ids, keys) % ids.size]
    for use_buckets in (True, False):
        np.testing.assert_array_equal(
            state.lookup(keys, use_buckets=use_buckets), want)
    q = torch.randn((1, 2, 16), device=cuda)
    kv = torch.randn((1, 8, 1, 16), device=cuda)
    da_ops.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32,
                                                  device=cuda))
    table, keys = _k7_case(1000, True)
    rl_ops.ring_lookup(torch.from_numpy(keys.view(np.int32)).to(cuda),
                       torch.from_numpy(table.view(np.int32)).to(cuda))
    simulate_churn(ChurnConfig(n=512, s_avg=174 * 60, duration=120,
                               warmup=30, seed=1), device=cuda)
    fa_ops.flash_attention(q[:, None], kv, kv, causal=True)
    x = torch.randn((1, 5, 8), device=cuda)
    bc = torch.randn((1, 5, 4), device=cuda)
    ssm_ops.ssm_scan(x, x.abs(), bc, bc, -torch.ones((8, 4), device=cuda),
                     torch.ones(8, device=cuda))


# K5 tolerances: repro's own (tests/test_kernels.py), kernel and plain
# version both f32 inside; fp16 (finer than bf16) takes bf16's
K5_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal", [
    (1, 1024, 1024, 16, 2, 128, True),      # qwen2.5-3b's admit (g 8)
    (1, 1000, 1000, 16, 2, 128, True),      # ragged
    (2, 300, 777, 8, 2, 64, False),         # Sq != Sk
    (3, 77, 200, 4, 4, 16, True),           # Sq < Sk, top-left mask
    (2, 128, 128, 4, 1, 32, True),
    (1, 1, 1, 2, 2, 128, True),             # one query, g 1
    (2, 63, 63, 4, 2, 64, True),            # g 2, one ragged tile
    (1, 65, 65, 8, 1, 128, True),           # g 8, a 1-row second tile
    (2, 1024, 512, 8, 1, 64, True),         # Sk < Sq, causal
    (1, 65, 200, 4, 2, 128, False),         # Sq != Sk, no mask
    (2, 1000, 63, 2, 2, 64, False),         # one ragged kv tile
    (1, 1024, 1024, 32, 32, 112, True),     # zamba2-7b's admit (g 1, hd 112)
    (2, 200, 333, 4, 2, 112, False),        # hd 112, Sq != Sk, ragged
    (1, 65, 65, 8, 1, 112, True),           # hd 112, g 8, a 1-row tile
    (2, 1500, 1500, 12, 12, 64, False),     # whisper-small's encoder
    (2, 4, 1500, 12, 12, 64, False),        # its cross prefill (Sq 4)
])
def test_flash_attention_kernel_equals_plain(cuda, dtype, b, sq, sk, h, hkv,
                                             hd, causal):
    g = torch.Generator(device=cuda).manual_seed(sq * sk + hd)
    q = torch.randn((b, sq, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, sk, hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, sk, hkv, hd), generator=g, device=cuda).to(dtype)
    tc = dtype != torch.float32 and hd in (64, 112, 128)
    assert fa_kernel.route(dtype, hd) == ("tc" if tc else "simt")
    fn = fa_ops.flash_attention
    before = fn.launches, fn.tc_launches, fn.simt_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches, fn.simt_launches) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=K5_TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [1024, 1000])
def test_flash_attention_at_six_query_heads_a_kv_head(cuda, dtype, s):
    """An internlm2-20b whole-prompt admit's attention (48 heads over 8
    kv heads, g = 6, hd 128, causal): on the tensor cores."""
    b, h, hkv, hd = 1, 48, 8, 128
    g = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((b, s, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    fn = fa_ops.flash_attention
    before = fn.tc_launches
    got = fn(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fn.tc_launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=K5_TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [1024, 1000])
def test_flash_attention_at_sixteen_query_heads_a_kv_head(cuda, dtype, s):
    """A qwen3-moe-235b-a22b whole-prompt admit's attention (64 heads over
    4 kv heads, g = 16, hd 128, causal): on the tensor cores."""
    b, h, hkv, hd = 1, 64, 4, 128
    g = torch.Generator(device=cuda).manual_seed(s + 16)
    q = torch.randn((b, s, h, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=g, device=cuda).to(dtype)
    fn = fa_ops.flash_attention
    before = fn.tc_launches
    got = fn(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fn.tc_launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=K5_TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,causal", [
    (1, 1024, 1024, 128, 128, True),        # deepseek-v2's admit
    (1, 1000, 1000, 16, 16, True),          # ragged
    (2, 77, 200, 4, 4, False),              # Sq != Sk, no mask
    (1, 65, 65, 8, 2, True),                # g 4, a 1-row second tile
    (2, 1024, 300, 4, 4, True),             # Sk < Sq, causal
])
def test_flash_attention_at_mla_head_dims(cuda, dtype, b, sq, sk, h, hkv,
                                          causal):
    """MLA's prefill: q and k at a q . k head dim of 192 (128 nope + 64
    rope), v at 128; bf16 and fp16 on the tensor cores, f32 on the SIMT
    kernel, each within its tolerance of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(sq * sk + 192)
    q = torch.randn((b, sq, h, 192), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, sk, hkv, 192), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, sk, hkv, 128), generator=g, device=cuda).to(dtype)
    tc = dtype != torch.float32
    assert fa_kernel.route(dtype, 192, 128) == ("tc" if tc else "simt")
    fn = fa_ops.flash_attention
    before = fn.launches, fn.tc_launches, fn.simt_launches
    got = fn(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fn.launches, fn.tc_launches, fn.simt_launches) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, sq, h, 128)
    torch.testing.assert_close(got.float(), want.float(), atol=K5_TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q, q, causal=True)
    q = torch.randn((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="head dim"):     # v narrower
        fa_ops.flash_attention(q, q, q[..., :32].contiguous(), causal=True)
    q = torch.randn((1, 8, 3, 16), device=cuda)
    with pytest.raises(ValueError, match="mismatched"):
        fa_ops.flash_attention(q, q[:, :, :2].contiguous(),
                               q[:, :, :2].contiguous(), causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2), q, q, causal=True)
    # TMA reads from a 16-byte-aligned base: a view one element in is refused
    buf = torch.randn(2 * 8 * 2 * 64 + 1, device=cuda).to(torch.bfloat16)
    q = buf[1:].view(2, 8, 2, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    kv = buf[:-1].view(2, 8, 2, 64)
    before = fa_ops.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa_ops.flash_attention(q, kv, kv, causal=True)
    assert fa_ops.flash_attention.launches == before


def _scan_inputs(bb, l, din, n, dtype, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale
    return (rnd(bb, l, din, scale=0.1).to(dtype),
            rnd(bb, l, din, scale=0.1).abs(),
            rnd(bb, l, n, scale=0.5).to(dtype),
            rnd(bb, l, n, scale=0.5).to(dtype),
            -rnd(din, n).abs() - 0.1,
            torch.ones(din, device=cuda).to(dtype),
            rnd(bb, din, n, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("bb,l,din,n", [
    (1, 1024, 8192, 16),        # falcon-mamba-7b's admit
    (2, 64, 256, 16), (1, 128, 512, 8), (3, 32, 256, 4),
    (2, 37, 300, 5),            # ragged Din, N not a power of two
    (1, 3, 40, 32),
])
def test_ssm_scan_kernel_equals_plain(cuda, dtype, with_h0, bb, l, din, n):
    """h_last within repro's 1e-4 (f32 maths in both; the kernel's scan
    over segments sums in another order and takes its exponentials on
    the SFU); y within 1e-4 in f32, and within 2 bf16 ulps in bf16."""
    x, dt, B, C, A, D, h0 = _scan_inputs(bb, l, din, n, dtype, cuda,
                                         seed=l * din + n)
    h0 = h0 if with_h0 else None
    before = ssm_ops.ssm_scan.launches
    y, h = ssm_ops.ssm_scan(x, dt, B, C, A, D, h0)
    torch.cuda.synchronize()
    assert ssm_ops.ssm_scan.launches == before + 1
    wy, wh = ssm_ref.ssm_scan_ref(x, dt, B, C, A, D, h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(h, wh, atol=1e-4, rtol=0)
    atol = 1e-4 if dtype == torch.float32 else 2 ** -6 * max(
        1.0, float(wy.float().abs().max()))
    torch.testing.assert_close(y.float(), wy.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("l,din,n", [
    (1, 40, 1),                 # one position: a tile of padding
    (127, 300, 5),              # a tile short of two, ragged Din and N
    (1024, 96, 16),             # the admit's length
    (1025, 33, 32),             # one past 16 tiles, one channel past a block
    (2049, 64, 16),             # 32 tiles and one position
])
def test_ssm_scan_kernel_across_tiles(cuda, dtype, with_h0, l, din, n):
    """The scan over segments and tiles at lengths off and on the tile
    grid, ragged channel blocks, N from 1 to 32: h_last within 1e-4, y
    within 1e-4 in f32 and 2 bf16 ulps of max |y| in bf16 and fp16."""
    x, dt, B, C, A, D, h0 = _scan_inputs(1, l, din, n, dtype, cuda,
                                         seed=l + din + n)
    h0 = h0 if with_h0 else None
    y, h = ssm_ops.ssm_scan(x, dt, B, C, A, D, h0)
    torch.cuda.synchronize()
    wy, wh = ssm_ref.ssm_scan_ref(x, dt, B, C, A, D, h0)
    assert y.dtype == dtype and h.shape == (1, din, n)
    torch.testing.assert_close(h, wh, atol=1e-4, rtol=0)
    atol = 1e-4 if dtype == torch.float32 else 2 ** -6 * max(
        1.0, float(wy.float().abs().max()))
    torch.testing.assert_close(y.float(), wy.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_kernel_on_unaligned_views(cuda, dtype):
    """Contiguous views one element into their storage are not 16-byte
    aligned: the kernel stages them with plain loads, not cp.async, and
    gives the same answer."""
    l, din, n = 200, 64, 16
    x, dt, B, C, A, D, h0 = _scan_inputs(1, l, din, n, dtype, cuda, seed=5)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view
    args = [shifted(t) for t in (x, dt, B, C)] + [A, D, h0]
    y, h = ssm_ops.ssm_scan(*args)
    wy, wh = ssm_ref.ssm_scan_ref(x, dt, B, C, A, D, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, wh, atol=1e-4, rtol=0)
    atol = 1e-4 if dtype == torch.float32 else 2 ** -6 * max(
        1.0, float(wy.float().abs().max()))
    torch.testing.assert_close(y.float(), wy.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_ssm_scan_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, B, C, A, D, h0 = _scan_inputs(1, 8, 16, 4, torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="float32"):
        ssm_ops.ssm_scan(x, dt.bfloat16(), B, C, A, D)
    with pytest.raises(ValueError, match="share"):
        ssm_ops.ssm_scan(x, dt, B.float(), C, A, D)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_ops.ssm_scan(x, dt, B, C, A.t().contiguous().t(), D)
    wide = _scan_inputs(1, 8, 16, 33, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="N <= 32"):
        ssm_ops.ssm_scan(*wide[:6])


@pytest.mark.cuda
def test_ssm_replica_on_the_card_matches_the_cpu(cuda):
    """falcon-mamba-7b smoke() in f32, TF32 off: whole-prompt admits (K6)
    and fused lockstep rounds on the card give the CPU replica's tokens
    and owners."""
    cfg = get_smoke_config("falcon-mamba-7b").with_overrides(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (3, 20, 33)]
    streams = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
        for i in range(4):
            mem.request_join(f"10.2.0.{i}", 9000)
        rep = Replica(model, slots=8, max_len=64, device=dev)
        rep.attach_params(p)
        before = ssm_ops.ssm_scan.launches
        got = {f"s{i}": [rep.admit(Request(f"s{i}", pr))]
               for i, pr in enumerate(prompts)}
        if dev != "cpu":
            assert ssm_ops.ssm_scan.launches == before + 3 * cfg.num_layers
        owners = []
        for _ in range(6):
            for sid, tok in rep.decode_round(
                    route=mem.ring_state.device_bucket_table()).items():
                got[sid].append(tok)
            owners.append(dict(rep.routed_owners))
        streams[str(dev)] = (got, owners)
    assert streams["cpu"] == streams[str(cuda)]


EDRA_VARIANTS = [dict(theta=0.0), dict(theta=5.4947),
                 dict(theta=5.4947, fill_rate=172.8, e_cap=7.0)]


def _edra_pairs(p, n, device, seed=0):
    """(P,) pairs on ring(s) near n; ids as int32 holding uint32 bits."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(n - 64, n + 1, p, dtype=np.uint64)
    words = [rng.integers(0, ring), ring, rng.integers(0, ring),
             rng.integers(0, 2**32, p, dtype=np.uint64)]
    offset, nn, rep, key = (torch.from_numpy(w.astype(np.uint32).view(
        np.int32)).to(device) for w in words)
    t0 = torch.from_numpy(rng.uniform(0, 2100, p).astype(np.float32))
    return offset, nn, rep, t0.to(device), key


@pytest.mark.cuda
@pytest.mark.parametrize("variant", range(3))
@pytest.mark.parametrize("n,levels", [(1000, 10), (1_000_000, 20),
                                      (2**32 - 5, 32)])
def test_edra_tree_kernel_equals_plain(cuda, variant, n, levels):
    """Integers bit-equal; ack within repro's rtol=3e-5, atol=1e-3 (the
    kernel's float steps are the plain version's, one rounding each,
    so the acks are expected to be bit-equal too)."""
    args = _edra_pairs(70_001, n, cuda, seed=variant)
    kw = dict(levels=levels, delta_avg=7e-5, seed=1, **EDRA_VARIANTS[variant])
    before = et_ops.edra_tree.launches
    got = et_ops.edra_tree(*args, **kw)
    torch.cuda.synchronize()
    assert et_ops.edra_tree.launches == before + 1
    want = et_ref.tree_math(*args, **kw)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[0], want[0], rtol=3e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", range(3))
@pytest.mark.parametrize("p,n,levels", [
    (70_001, 1000, 10), (70_001, 1_000_000, 20),
    (70_001, 2**32 - 5, 32),    # rep + cur wraps: the per-hop modulo
    (1, 1_000_000, 20),         # one pair
    (300, 1_000_000, 20),       # a tile and a ragged one
])
def test_edra_tree_acks_bit_equal(cuda, variant, p, n, levels):
    """Every output bit-equal to the plain version, acks included (the
    kernel's float steps are tree_math's, one rounding each)."""
    args = _edra_pairs(p, n, cuda, seed=7 + variant)
    kw = dict(levels=levels, delta_avg=7e-5, seed=3, **EDRA_VARIANTS[variant])
    got = et_ops.edra_tree(*args, **kw)
    torch.cuda.synchronize()
    want = et_ref.tree_math(*args, **kw)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_edra_tree_kernel_refuses_wrong_types(cuda):
    args = list(_edra_pairs(64, 1000, cuda))
    kw = dict(levels=10, theta=1.0, delta_avg=0.01)
    for i, bad in ((0, args[0].long()), (3, args[3].double()),
                   (1, args[1][:32]),
                   (2, torch.empty(128, dtype=torch.int32,
                                   device=cuda)[::2])):
        call = list(args)
        call[i] = bad
        with pytest.raises(ValueError, match="edra_tree"):
            et_ops.edra_tree(*call, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        et_kernel.edra_tree_cuda(*(a.cpu() for a in args), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", ["d1ht", "calot"])
def test_simulate_churn_on_the_card_equals_the_cpu(cuda, protocol):
    cfg = ChurnConfig(n=2048, s_avg=174 * 60, duration=300, warmup=60,
                      seed=9, protocol=protocol)
    before = et_ops.edra_tree.launches
    card = simulate_churn(cfg, device=cuda, chunk=1 << 16)
    assert et_ops.edra_tree.launches > before
    host = simulate_churn(cfg, device="cpu", chunk=1 << 16)
    for f in ("events", "quarantine_admitted", "quarantine_skipped"):
        assert getattr(card, f) == getattr(host, f)
    for f in ("one_hop_fraction", "mean_out_bps", "sum_out_bps",
              "mean_ack_s", "p99_ack_s"):
        assert getattr(card, f) == pytest.approx(getattr(host, f), rel=1e-6)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [8, None])
def test_replica_on_the_card_matches_the_cpu(cuda, chunk):
    """f32 smoke model, TF32 off: chunked or whole-prompt (K5) admits and
    fused rounds on the card give the CPU replica's tokens and owners."""
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (3, 9, 17)]
    streams = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
        for i in range(4):
            mem.request_join(f"10.2.0.{i}", 9000)
        rep = Replica(model, slots=8, max_len=64, prefill_chunk=chunk,
                      device=dev)
        rep.attach_params(p)
        got = {f"s{i}": [rep.admit(Request(f"s{i}", pr))]
               for i, pr in enumerate(prompts)}
        owners = []
        for _ in range(6):
            for sid, tok in rep.decode_round(
                    route=mem.ring_state.device_bucket_table()).items():
                got[sid].append(tok)
            owners.append(dict(rep.routed_owners))
        streams[str(dev)] = (got, owners)
    assert streams["cpu"] == streams[str(cuda)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,chunk", [("zamba2-7b", None),
                                        ("qwen3-moe-235b-a22b", 8),
                                        ("qwen3-moe-235b-a22b", None)])
def test_family_replica_on_the_card_matches_the_cpu(cuda, arch, chunk):
    """zamba2-7b smoke() (Mamba-2 and the shared block: K5 prefill, K3
    lockstep decode) and qwen3-moe smoke() (chunked or whole admits,
    per-slot decode) in f32, TF32 off: admits and fused rounds on the
    card give the CPU replica's tokens and owners."""
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (3, 20, 33)]
    streams = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
        for i in range(4):
            mem.request_join(f"10.2.0.{i}", 9000)
        rep = Replica(model, slots=8, max_len=64, prefill_chunk=chunk,
                      device=dev)
        rep.attach_params(p)
        before = fa_ops.flash_attention.launches, da_ops.decode_attention.launches
        got = {f"s{i}": [rep.admit(Request(f"s{i}", pr))]
               for i, pr in enumerate(prompts)}
        owners = []
        for _ in range(6):
            for sid, tok in rep.decode_round(
                    route=mem.ring_state.device_bucket_table()).items():
                got[sid].append(tok)
            owners.append(dict(rep.routed_owners))
        if dev != "cpu":
            sites = -(-cfg.num_layers // cfg.shared_attn_every) \
                if cfg.shared_attn_every else cfg.num_layers
            whole = chunk is None
            assert fa_ops.flash_attention.launches - before[0] \
                == (3 * sites if whole else 0)
            assert da_ops.decode_attention.launches - before[1] == 6 * sites
        streams[str(dev)] = (got, owners)
    assert streams["cpu"] == streams[str(cuda)]


# ---------------------------------------------------------------------------
# everywhere: no silent fallback to the CPU, no plain version off the CPU
# ---------------------------------------------------------------------------

def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(get_smoke_config("qwen2.5-3b"))
    ssm = Model(get_smoke_config("falcon-mamba-7b"))
    hybrid = Model(get_smoke_config("zamba2-7b"))
    moe = Model(get_smoke_config("qwen3-moe-235b-a22b"))
    for call in (lambda: model.init(),
                 lambda: model.init_cache(1, 8),
                 lambda: Replica(model, slots=2, max_len=8),
                 lambda: ssm.init(),
                 lambda: ssm.init_cache(1, 8),
                 lambda: Replica(ssm, slots=2, max_len=8),
                 lambda: hybrid.init(),
                 lambda: Replica(hybrid, slots=2, max_len=8),
                 lambda: moe.init(),
                 lambda: Replica(moe, slots=2, max_len=8),
                 lambda: RingState([1, 2, 3]).device_bucket_table(),
                 lambda: simulate_churn(ChurnConfig(n=64, s_avg=600.0)),
                 lambda: Membership().ring_state.device_table(),
                 lambda: quickstart.run(out=lambda line: None)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_ring_lookup_refuses_non_cuda_tensors_and_empty_tables():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rl_ops.ring_lookup(meta, meta)
    cpu = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        rl_kernel.ring_lookup_cuda(cpu, cpu)
    for keys in (meta, cpu):
        with pytest.raises(LookupError, match="empty routing table"):
            rl_ops.ring_lookup(keys, keys[:0])


def test_launchers_refuse_non_cuda_tensors():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rl_ops.ring_lookup64(meta, meta, meta, meta, meta[:1])
    with pytest.raises(ValueError, match="CUDA"):
        rl_ops.ring_lookup_bucketed(
            meta, meta, torch.empty((1, 128), dtype=torch.int32,
                                    device="meta"),
            torch.empty((1, 128), dtype=torch.int32, device="meta"),
            meta[:1])
    q = torch.empty((1, 2, 16), device="meta")
    kv = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        da_ops.decode_attention(q, kv, kv, meta[:1])
    t0 = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        et_ops.edra_tree(meta, meta, meta, t0, meta, levels=4, theta=1.0,
                         delta_avg=0.01)
    cpu = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        et_kernel.edra_tree_cuda(cpu, cpu + 5, cpu, cpu.float(), cpu,
                                 levels=4, theta=1.0, delta_avg=0.01)
    with pytest.raises(ValueError, match="CUDA"):
        fa_ops.flash_attention(q[:, None], kv, kv, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_cuda(torch.zeros((1, 1, 2, 16)),
                                       torch.zeros((1, 8, 1, 16)),
                                       torch.zeros((1, 8, 1, 16)),
                                       causal=True)
    x, bc = torch.empty((1, 8, 4), device="meta"), \
        torch.empty((1, 8, 2), device="meta")
    a, d = torch.empty((4, 2), device="meta"), torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ssm_ops.ssm_scan(x, x, bc, bc, a, d)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_kernel.ssm_scan_cuda(*(torch.zeros(t.shape)
                                   for t in (x, x, bc, bc, a, d)))

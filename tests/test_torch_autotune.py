"""The port's launch-shape autotune (``repro_torch.kernels.autotune``)
against ``repro.kernels.autotune`` on the same inputs, and its own
contract on the CPU: the shape buckets and the cache file read alike, the
CPU resolves to the defaults with no file I/O, a search on a faked card
persists its argmin and the cache keys on the card's name, compute
capability and the kernels' source digest, the file is read once a
process, and the defaults are the launchers' constants."""
import builtins
import json
import re
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import autotune as j_autotune
from repro_torch.kernels import autotune, build
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.ring_lookup import kernel as rk
from repro_torch.kernels.ssm_scan import kernel as sk

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
CARD = torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# the same functions as repro's
# ---------------------------------------------------------------------------

def test_shape_bucket_literal_cases_match_repro():
    for dims in ({"q": 1000, "n": 70_000}, {"q": 1024}, {"s": 1}):
        assert autotune.shape_bucket(**dims) == j_autotune.shape_bucket(**dims)
    assert autotune.shape_bucket(q=1000, n=70_000) == "n131072_q1024"
    assert autotune.shape_bucket(q=1024) == "q1024"
    assert autotune.shape_bucket(s=1) == "s1"


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.dictionaries(st.sampled_from(["q", "n", "b", "s", "h", "hd", "p",
                                        "words", "tc"]),
                       st.integers(0, 2**40), min_size=1))
def test_shape_bucket_matches_repro_on_drawn_dims(dims):
    assert autotune.shape_bucket(**dims) == j_autotune.shape_bucket(**dims)


@pytest.mark.parametrize("content", [
    None,                                               # missing
    "{ not json !!!",                                   # corrupt
    json.dumps({"version": 999, "entries": {"x": {"tiles": {"a": 1}}}}),
    json.dumps({"version": 1, "entries": []}),          # entries not a dict
    json.dumps([1, 2, 3]),                              # not a dict
    json.dumps({"version": 1, "entries": {
        "k/ring_lookup/q1024": {"tiles": {"blocks_per_sm": 2}}}}),
])
def test_load_cache_matches_repro(tmp_path, content):
    path = tmp_path / "autotune.json"
    if content is not None:
        path.write_text(content)
    assert autotune.CACHE_VERSION == j_autotune.CACHE_VERSION
    assert autotune.load_cache(str(path)) == j_autotune.load_cache(str(path))


def test_the_six_kernel_keys_are_repros():
    assert autotune.KERNELS == j_autotune.KERNELS
    assert set(autotune.CANDIDATES) == set(autotune.DEFAULTS)
    for kernel, base in autotune.DEFAULTS.items():
        assert base in autotune.CANDIDATES[kernel]      # the default races


# ---------------------------------------------------------------------------
# the CPU: defaults, no file I/O
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.reset()
    yield path
    autotune.reset()


def test_cpu_tiles_for_returns_defaults_without_opening_a_file(fresh,
                                                               monkeypatch):
    def no_open(*a, **k):
        raise AssertionError(f"file opened: {a}")

    fresh.write_text(json.dumps({"version": 1, "entries": {}}))
    monkeypatch.setattr(builtins, "open", no_open)
    for kernel in autotune.KERNELS:
        for dev in (None, "cpu", torch.device("cpu")):
            assert autotune.tiles_for(kernel, dev, q=4096, s=2048) \
                == autotune.DEFAULTS[kernel]
    assert autotune.autotune_kernel("edra_tree", {"p": 1 << 21},
                                    device="cpu") \
        == autotune.DEFAULTS["edra_tree"]
    assert autotune.status_label() == "defaults"


def test_cpu_autotune_all_searches_nothing(fresh):
    out = autotune.autotune_all(device="cpu", records={})
    assert set(out) == {f"{k}/{autotune.shape_bucket(**d)}"
                        for k, ds in autotune.SWEEP_DIMS.items() for d in ds}
    for name, tiles in out.items():
        assert tiles == autotune.DEFAULTS[name.split("/")[0]]
    assert not fresh.exists()


def test_cpu_launch_shapes_are_todays(fresh):
    """With no cache the launchers' knobs are exactly the shipped ones:
    K3's heuristic chunk / splits, K7's crossover."""
    for b, s in ((1, 2048), (8, 2048), (16, 2048), (32, 4096), (4, 448)):
        assert dk.launch_plan(torch.bfloat16, b, s, 16, 2, 128) \
            == ("tc", dk.chunk_positions(b, 2, s))
        assert dk.launch_plan(torch.float32, b, s, 16, 2, 128) \
            == ("simt", dk.num_splits(b, 2, s))
    table = torch.zeros(1000, dtype=torch.int32)
    for q in (1, 4096, rk.K7_SAMPLE_KEYS, rk.K7_SAMPLE_KEYS + 1):
        keys = torch.zeros(q, dtype=torch.int32)
        assert rk.k7_route_for(keys, table) == rk.k7_route(q)
    assert rk.k7_route(rk.K7_SAMPLE_KEYS) == "one_level"


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+);",
                  (CSRC / source).read_text())
    assert m, (source, name)
    return int(m.group(1))


def test_defaults_equal_the_launchers_constants():
    """Drift guard: each default is the constant the launch shipped with."""
    d = autotune.DEFAULTS
    assert d["ring_lookup"]["blocks_per_sm"] == _constant("ring_lookup.cu",
                                                          "kK1BlocksPerSM")
    assert d["ring_lookup"]["sample_keys"] == rk.K7_SAMPLE_KEYS
    assert d["ring_lookup_bucketed"]["warp_keys"] == _constant(
        "ring_lookup.cu", "kK2WarpKeys")
    assert d["edra_tree"]["grid_waves"] == _constant("edra_tree.cu",
                                                     "kGridWaves")
    assert d["decode_attention"] == {"chunk": 0, "splits": 0}
    assert autotune._K3_CHUNKS == dk.CHUNKS
    assert d["flash_attention"] == {
        "bm": _constant("flash_attention_tc.cu", "kBM"),
        "bn": _constant("flash_attention_tc.cu", "kBN")}
    assert d["flash_attention"]["bm"] == fk.BQ
    assert d["ssm_scan"]["channels"] == _constant("ssm_scan.cu",
                                                  "kChannels") == sk.CHANNELS
    # each knob reaches its launch as an argument, not a constant
    ring = (CSRC / "ring_lookup.cu").read_text()
    assert "static_cast<int64_t>(sms) * blocks_per_sm);" in ring
    assert "if (q <= warp_keys) {" in ring
    assert "blocks = resident * grid_waves;" in (CSRC / "edra_tree.cu"
                                                 ).read_text()


# ---------------------------------------------------------------------------
# a faked card: search, persistence, keying
# ---------------------------------------------------------------------------

@pytest.fixture
def card(fresh, monkeypatch):
    """Pretend to be on an H100 with these sources, private cache file."""
    monkeypatch.setattr(autotune, "_on_card", lambda dev: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda idx=None: "Fake H100")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda idx=None: (9, 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build, "source_digest", lambda: "abc123")
    monkeypatch.setattr(autotune, "_device_keys", {})
    yield fresh


def _bench(order):
    calls = []

    def bench(tiles):
        calls.append(dict(tiles))
        return float(order(tiles))

    bench.calls = calls
    return bench


def test_search_picks_the_argmin_and_persists_it(card):
    bench = _bench(lambda t: abs(t["warp_keys"] - 16384))
    dims = {"q": 32, "b": 1 << 15}
    rec = {}
    got = autotune.autotune_kernel("ring_lookup_bucketed", dims, bench=bench,
                                   device=CARD, record=rec)
    assert got == {"warp_keys": 16384}
    assert bench.calls == autotune.CANDIDATES["ring_lookup_bucketed"]
    assert rec["winner"] == got and rec["default_ms"] == 16384 - 4096
    data = json.loads(card.read_text())
    key = "Fake H100/sm90/abc123/ring_lookup_bucketed/b32768_q32"
    assert data["version"] == autotune.CACHE_VERSION
    assert data["entries"][key]["tiles"] == got
    # resolution finds it, for any dims of the bucket
    for q in (17, 32):
        assert autotune.tiles_for("ring_lookup_bucketed", CARD, q=q,
                                  b=1 << 15) == got
    assert autotune.status_label() == "searched"


def test_cache_hit_returns_without_a_search(card):
    autotune.autotune_kernel("edra_tree", {"p": 1 << 21},
                             bench=_bench(lambda t: -t["grid_waves"]),
                             device=CARD)
    again = _bench(lambda t: t["grid_waves"])
    assert autotune.autotune_kernel("edra_tree", {"p": 1 << 21}, bench=again,
                                    device=CARD) == {"grid_waves": 8}
    assert again.calls == []
    forced = _bench(lambda t: t["grid_waves"])
    assert autotune.autotune_kernel("edra_tree", {"p": 1 << 21}, bench=forced,
                                    device=CARD, force=True) \
        == {"grid_waves": 1}
    assert forced.calls


def test_a_refused_candidate_is_a_loss_and_a_fault_raises(card):
    def bench(tiles):
        if tiles["grid_waves"] == 1:
            raise build.KernelLaunchError("refused before a launch")
        return float(tiles["grid_waves"])
    assert autotune.autotune_kernel("edra_tree", {"p": 4096}, bench=bench,
                                    device=CARD) == {"grid_waves": 2}

    def faulty(tiles):
        if tiles["grid_waves"] == 8:
            raise autotune.AutotuneFault("output differs from the default's")
        return 1.0
    with pytest.raises(autotune.AutotuneFault):
        autotune.autotune_kernel("edra_tree", {"p": 1 << 20}, bench=faulty,
                                 device=CARD)
    # every candidate refused: the defaults, nothing persisted
    def refuse(tiles):
        raise ValueError("refused")
    assert autotune.autotune_kernel("edra_tree", {"p": 1 << 10},
                                    bench=refuse, device=CARD) \
        == autotune.DEFAULTS["edra_tree"]


def _write_entry(path, key, tiles):
    data = autotune.load_cache(str(path))
    data["entries"][key] = {"tiles": tiles}
    autotune._save_cache(data, str(path))


@pytest.mark.parametrize("prefix,tiles,hit", [
    ("Fake H100/sm90/abc123", {"grid_waves": 2}, True),
    ("Fake H100/sm90/abc123", {"grid_waves": 3}, False),     # no candidate
    ("Fake H100/sm90/abc123", {"waves": 2}, False),          # wrong knob
    ("Fake H100/sm90/abc123", {"grid_waves": "two"}, False),  # not an int
    ("Fake H100/sm90/zzz999", {"grid_waves": 2}, False),     # other sources
    ("Fake A100/sm90/abc123", {"grid_waves": 2}, False),     # other card
    ("Fake H100/sm80/abc123", {"grid_waves": 2}, False),     # other arch
])
def test_resolution_ignores_invalid_and_foreign_entries(card, prefix, tiles,
                                                        hit):
    _write_entry(card, f"{prefix}/edra_tree/p2097152", tiles)
    got = autotune.tiles_for("edra_tree", CARD, p=2_000_000)
    assert got == (tiles if hit else autotune.DEFAULTS["edra_tree"])
    assert autotune.status_label() == ("cache" if hit else "defaults")


def test_invalid_candidates_for_the_call_fall_back(card):
    """K1 and K7 share a key: a K7 switch is no K1 candidate; K3's SIMT
    splits are no tensor-core candidate and past the tiles they are none."""
    base = "Fake H100/sm90/abc123"
    _write_entry(card, f"{base}/ring_lookup/n1048576_q1048576_words2",
                 {"blocks_per_sm": 1, "sample_keys": 1024})
    assert autotune.tiles_for("ring_lookup", CARD, q=1 << 20, n=1 << 20,
                              words=2) == autotune.DEFAULTS["ring_lookup"]
    dims = dict(b=16, h=16, hd=128, hkv=2, s=2048, tc=1)
    _write_entry(card, f"{base}/decode_attention/"
                 f"{autotune.shape_bucket(**dims)}", {"chunk": 0, "splits": 8})
    assert autotune.tiles_for("decode_attention", CARD, **dims) \
        == autotune.DEFAULTS["decode_attention"]
    short = dict(dims, s=64, tc=0)
    _write_entry(card, f"{base}/decode_attention/"
                 f"{autotune.shape_bucket(**short)}",
                 {"chunk": 0, "splits": 4})
    assert autotune.tiles_for("decode_attention", CARD, **short) \
        == autotune.DEFAULTS["decode_attention"]      # 4 splits > 2 tiles
    assert {"chunk": 0, "splits": 2} in autotune.candidates_for(
        "decode_attention", short)


def test_the_file_is_read_once_a_process(card, monkeypatch):
    reads = []
    real = autotune.load_cache

    def counting(path=None):
        reads.append(path)
        return real(path)
    monkeypatch.setattr(autotune, "load_cache", counting)
    _write_entry(card, "Fake H100/sm90/abc123/edra_tree/p1024",
                 {"grid_waves": 8})
    reads.clear()
    for p in range(600, 1025):
        assert autotune.tiles_for("edra_tree", CARD, p=p) == {"grid_waves": 8}
        autotune.tiles_for("ring_lookup_bucketed", CARD, q=p, b=64)
    assert len(reads) == 1
    # after this process writes the file, the next resolution re-reads it
    autotune.autotune_kernel("edra_tree", {"p": 1024}, force=True,
                             bench=_bench(lambda t: t["grid_waves"]),
                             device=CARD)
    reads.clear()
    assert autotune.tiles_for("edra_tree", CARD, p=1000) == {"grid_waves": 1}
    assert len(reads) == 1


def test_a_corrupt_file_gives_defaults_and_a_search_rewrites_it(card):
    card.write_text("{ not json !!!")
    assert autotune.tiles_for("ring_lookup", CARD, q=4096, n=1 << 20,
                              words=1) == autotune.DEFAULTS["ring_lookup"]
    autotune.autotune_kernel("ring_lookup", {"q": 4096, "n": 1 << 20,
                                             "words": 1},
                             bench=_bench(lambda t: -t["sample_keys"]),
                             device=CARD)
    assert autotune.tiles_for("ring_lookup", CARD, q=4096, n=1 << 20,
                              words=1) == {"blocks_per_sm": 1,
                                           "sample_keys": 1 << 22}


def test_the_cache_is_the_ports_own_file(monkeypatch, tmp_path):
    """The port reads only the file its own variable names: never repro's,
    and with the variable unset none at all."""
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.delenv(j_autotune.CACHE_ENV, raising=False)
    assert autotune.CACHE_ENV != j_autotune.CACHE_ENV
    assert autotune.cache_path() is None
    assert j_autotune.cache_path() is not None
    monkeypatch.setenv(j_autotune.CACHE_ENV, str(tmp_path / "repro.json"))
    assert autotune.cache_path() is None
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "port.json"))
    assert autotune.cache_path() == str(tmp_path / "port.json")


def test_no_cache_variable_no_file_on_the_card(card, monkeypatch):
    """With ``REPRO_TORCH_AUTOTUNE_CACHE`` unset the card takes the
    defaults, opens no file, and a search refuses to run."""
    _write_entry(card, "Fake H100/sm90/abc123/edra_tree/p1024",
                 {"grid_waves": 8})
    monkeypatch.delenv(autotune.CACHE_ENV)
    autotune.reset()

    def no_open(*a, **k):
        raise AssertionError(f"file opened: {a}")
    monkeypatch.setattr(builtins, "open", no_open)
    assert autotune.tiles_for("edra_tree", CARD, p=1000) \
        == autotune.DEFAULTS["edra_tree"]
    assert autotune.status_label() == "defaults"
    bench = _bench(lambda t: t["grid_waves"])
    with pytest.raises(ValueError, match=autotune.CACHE_ENV):
        autotune.autotune_kernel("edra_tree", {"p": 1024}, bench=bench,
                                 device=CARD)
    assert bench.calls == []


@pytest.mark.parametrize("default_readings,want", [
    ([10.0, 10.0, 10.0], {"grid_waves": 8}),   # 9.5 < 10 - 0: it wins
    ([9.2, 10.0, 10.8], {"grid_waves": 4}),    # 9.5 >= 10 - 1.6: default
    ([9.9, 10.0, 10.2], {"grid_waves": 8}),    # 9.5 < 10 - 0.3: it wins
])
def test_the_default_stays_inside_its_own_spread(card, default_readings,
                                                 want):
    """A winner must beat the default's median by more than the spread of
    the default's readings; the cache records what was kept."""
    def bench(tiles):
        if tiles["grid_waves"] == 4:
            return default_readings
        return [9.5, 9.5, 9.5] if tiles["grid_waves"] == 8 else [20.0]
    rec = {}
    assert autotune.autotune_kernel("edra_tree", {"p": 1 << 21}, bench=bench,
                                    device=CARD, record=rec) == want
    assert rec["winner"] == want and rec["default_ms"] == 10.0
    assert rec["default_spread_ms"] == pytest.approx(
        max(default_readings) - min(default_readings))
    assert autotune.tiles_for("edra_tree", CARD, p=1 << 21) == want


def test_median_spread_reads_a_time_or_its_readings():
    assert autotune._median_spread(3) == (3.0, 0.0)
    assert autotune._median_spread([4.0, 1.0, 2.0]) == (2.0, 3.0)
    assert autotune._median_spread((5.0,)) == (5.0, 0.0)

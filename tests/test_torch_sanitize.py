"""The port's runtime invariant sanitizer (``repro_torch.analysis.sanitize``)
against ``repro.analysis.sanitize``: one seeded stream of ring churn,
block-store churn and replica admits and evicts through both packages'
sanitized classes runs every check the same number of times; each of
``repro``'s seeded violations raises ``SanitizeError`` in the port;
``install`` is idempotent and reversible; and ``REPRO_SANITIZE=1`` makes
``import repro_torch`` install it."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import sanitize as j_sanitize
from repro.configs import get_smoke_config as j_smoke
from repro.core.edra import Event as JEvent
from repro.core.ringstate import RingState as JRingState
from repro.dht.data import BlockStore as JBlockStore
from repro.models import Model as JModel
from repro.serve import Replica as JReplica
from repro.serve import Request as JRequest
from repro_torch.analysis import sanitize
from repro_torch.configs import get_smoke_config
from repro_torch.core.edra import Event
from repro_torch.core.ringstate import RingState
from repro_torch.dht.data import BlockStore
from repro_torch.models import Model
from repro_torch.serve import Replica, Request

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


@pytest.fixture
def sanitized():
    """Both packages' sanitizers installed (either may be already, under
    ``REPRO_SANITIZE``); removed after if this fixture installed it."""
    owned = sanitize.install()
    j_owned = j_sanitize.install()
    yield
    if owned:
        sanitize.uninstall()
    if j_owned:
        j_sanitize.uninstall()


@pytest.fixture(scope="module")
def models():
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _stream(pkg, models, seed: int):
    """One seeded op stream on one package's classes: ring churn with
    lookups, store churn with a sync, replica admits, rounds and evicts."""
    ring_cls, store_cls, event, replica_cls, request = pkg
    rng = np.random.default_rng(seed)
    ids = [int(x) for x in rng.choice(2**40, 24, replace=False)]
    kw = {} if ring_cls is JRingState else {"device": "cpu"}
    st = ring_cls(ids[:16], **kw)
    st.add(ids[16])
    st.set_quarantined(ids[16], True)
    st.set_quarantined(ids[16], False)
    st.remove(ids[3])
    st.apply_events([event(ids[17], "join", seq=1),
                     event(ids[4], "leave", seq=1)])
    keys = rng.integers(0, 2**40, 64, dtype=np.uint64)
    want = st.active_ids()
    got = st.lookup(keys)
    assert np.array_equal(got, want[np.searchsorted(want, keys) % want.size])
    store = store_cls(st, replication=2)
    for i in range(6):
        store.put(f"blk-{i}", bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
    st.remove(int(store._placement[store.key_of("blk-1")][0]))
    store.sync()
    store.remove("blk-2")
    st.add(ids[18])
    store.sync()
    if models is None:
        return
    jm, jp, m, p, cfg = models
    if replica_cls is JReplica:
        rep = JReplica(jm, slots=4, max_len=32, prefill_chunk=8)
        rep.attach_params(jp)
    else:
        rep = Replica(m, slots=4, max_len=32, prefill_chunk=8, device="cpu")
        rep.attach_params(p)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (5, 9, 12)]
    rep.admit(request("a", prompts[0], 4))
    rep.admit(request("b", prompts[1], 4))
    rep.decode_round()
    rep.evict("a")
    rep.begin_admit(request("c", prompts[2], 4))
    rep.advance_prefills(chunks=2)
    rep.decode_round()
    rep.evict("no-such-session")
    rep.evict("b")


def test_one_op_stream_runs_the_same_checks_in_both(sanitized, models):
    before, j_before = sanitize.stats(), j_sanitize.stats()
    _stream((RingState, BlockStore, Event, Replica, Request), models, 7)
    _stream((JRingState, JBlockStore, JEvent, JReplica, JRequest), models, 7)
    ran = {k: v - before.get(k, 0) for k, v in sanitize.stats().items()}
    j_ran = {k: v - j_before.get(k, 0) for k, v in j_sanitize.stats().items()}
    assert ran == j_ran
    assert set(ran) == {"ringstate", "ringstate.lookup", "blockstore.put",
                        "blockstore.sync", "blockstore.remove",
                        "replica.slots"}
    assert all(v > 0 for v in ran.values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_and_store_churn_counts_match_repro(sanitized, seed):
    before, j_before = sanitize.stats(), j_sanitize.stats()
    _stream((RingState, BlockStore, Event, None, None), None, seed)
    _stream((JRingState, JBlockStore, JEvent, None, None), None, seed)
    assert {k: v - before.get(k, 0) for k, v in sanitize.stats().items()} \
        == {k: v - j_before.get(k, 0) for k, v in j_sanitize.stats().items()}


# ---------------------------------------------------------------------------
# repro's seeded violations, in the port
# ---------------------------------------------------------------------------

def _ring(n=16):
    return RingState(range(100, 100 + n), device="cpu")


def test_sanitizer_catches_unsorted_ring_slab(sanitized):
    st = _ring()
    st._ids[0], st._ids[1] = st._ids[1], st._ids[0]    # corrupt order
    with pytest.raises(sanitize.SanitizeError, match="sorted"):
        st.add(7)


def test_sanitizer_catches_version_regression(sanitized):
    st = _ring()
    st.active_version = st.version + 10                # corrupt monotone
    with pytest.raises(sanitize.SanitizeError, match="version"):
        st.add(7)


def test_sanitizer_catches_a_quarantined_peer_in_the_active_view(sanitized):
    st = _ring()
    st.active_ids = lambda: st._ids[:st._n].copy()     # corrupt: no mask
    with pytest.raises(sanitize.SanitizeError, match="quarantined"):
        st.set_quarantined(105, True)


def test_sanitizer_catches_a_lookup_off_the_oracle(sanitized):
    class Skewed(RingState):
        def lookup(self, keys, **kw):
            return RingState.lookup(self, keys, **kw)[::-1].copy()

    n = len(sanitize._originals)
    sanitize._wrap_ring_lookup(Skewed)
    try:
        st = Skewed(range(100, 116), device="cpu")
        with pytest.raises(sanitize.SanitizeError, match="oracle"):
            st.lookup(np.array([99, 102, 105, 110, 1000], np.uint64))
    finally:
        del sanitize._originals[n:]


def test_sanitizer_catches_short_replica_group(sanitized):
    class ShortPolicy:
        def replica_group(self, state, key, r):
            return [int(state.active_ids()[0])]        # 1 < r copies

    store = BlockStore(_ring(8), replication=2, policy=ShortPolicy())
    with pytest.raises(sanitize.SanitizeError, match="placed on 1"):
        store.put("blk", b"payload")


def test_sanitizer_catches_tombstone_resurrection(sanitized):
    store = BlockStore(_ring(8), replication=2)
    store.put("keep", b"v1")
    store._tombs[store.key_of("keep")] = 99   # corrupt: placed AND buried
    with pytest.raises(sanitize.SanitizeError, match="tombstoned"):
        store.put("other", b"v2")


def test_sanitizer_catches_replica_slot_leak(sanitized, models):
    _, _, m, p, _ = models
    rep = Replica(m, slots=4, max_len=32, device="cpu")
    rep.attach_params(p)
    rep._free.pop()                                    # leak a slot
    with pytest.raises(sanitize.SanitizeError, match="slot leak"):
        rep.evict("no-such-session")


def test_sanitizer_checks_slots_on_exception_paths(sanitized, models):
    _, _, m, p, cfg = models
    rep = Replica(m, slots=2, max_len=16, device="cpu")
    rep.attach_params(p)
    before = sanitize.stats().get("replica.slots", 0)
    with pytest.raises(Exception):
        rep.admit(Request("long", np.zeros(40, np.int32), 4))  # > max_len
    assert sanitize.stats()["replica.slots"] == before + 1
    assert rep.num_free == 2


# ---------------------------------------------------------------------------
# install / uninstall, and the REPRO_SANITIZE flag
# ---------------------------------------------------------------------------

def test_install_is_idempotent_and_reversible():
    pre = {n: getattr(RingState, n) for n in ("add", "lookup")}
    owned = sanitize.install()
    try:
        assert getattr(RingState.add, "__repro_sanitized__", False)
        assert getattr(BlockStore.put, "__repro_sanitized__", False)
        assert getattr(Replica.decode_round, "__repro_sanitized__", False)
        assert sanitize.install() is False             # second: a no-op
    finally:
        if owned:
            sanitize.uninstall()
            assert {n: getattr(RingState, n) for n in pre} == pre
            assert not hasattr(RingState.add, "__repro_sanitized__")
            sanitize.uninstall()                       # idempotent too


_PROBE = """
import sys
import repro_torch
from repro_torch.core.ringstate import RingState
from repro_torch.dht.data import BlockStore
from repro_torch.serve.server import Replica
flags = [getattr(f, "__repro_sanitized__", False) for f in (
    RingState.add, RingState.lookup, BlockStore.sync, Replica.evict)]
print(all(flags), any(flags), "repro" in sys.modules)
"""


@pytest.mark.parametrize("flag,installed", [("1", True), ("yes", True),
                                            ("", False), ("0", False)])
def test_repro_sanitize_installs_the_ports_wrappers(flag, installed):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), REPRO_SANITIZE=flag)
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(installed), str(installed), "False"]

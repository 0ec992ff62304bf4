"""The port's serve plane against repro's, in lockstep: the same
Membership events and requests drive repro's and the port's
SessionRouter and Replica (qwen2.5-3b smoke() in float32, weights
converted from repro's), fused and unfused, through admit (whole and
chunked), begin_admit/advance_prefills, evict and failing admits.
After every operation the token streams, ``routed_owners`` and the slot
bookkeeping must be identical, and the KV slabs equal within 1e-4."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.runtime import Membership as JMembership
from repro.serve import Replica as JReplica
from repro.serve import Request as JRequest
from repro.serve import SessionRouter as JSessionRouter
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.runtime import Membership
from repro_torch.serve import Replica, Request, SessionRouter

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _memberships(n):
    t = [0.0]
    jmem = JMembership(t_q=60.0, now=lambda: t[0])
    mem = Membership(t_q=60.0, now=lambda: t[0], device="cpu")
    for i in range(n):
        jmem.request_join(f"10.3.0.{i}", 7000 + i)
        mem.request_join(f"10.3.0.{i}", 7000 + i)
    return jmem, mem


def test_router_routes_like_repro():
    jmem, mem = _memberships(4)
    sids = [f"user-{i}" for i in range(64)]
    router, jrouter = SessionRouter(mem), JSessionRouter(jmem)
    assert mem.members() == jmem.members()
    assert router.route(sids) == jrouter.route(sids)
    assert router.uploads == 1
    for _ in range(5):
        router.route(sids)
    assert router.uploads == 1          # membership unchanged: no upload
    # a quarantined spot node owns nothing; a failure re-routes like repro
    gate = mem.request_join("10.3.9.9", 9999, preemptible=True)
    assert jmem.request_join("10.3.9.9", 9999, preemptible=True) == gate
    assert gate not in router.route(sids)
    victim = mem.members()[1]
    mem.fail(victim)
    jmem.fail(victim)
    assert router.route(sids) == jrouter.route(sids)
    assert victim not in router.route(sids)


class _Lockstep:
    """One repro Replica and one port Replica driven op by op."""

    def __init__(self, pair, *, slots, max_len, chunk, fused, nodes=4):
        jm, jp, m, p, _ = pair
        self.jmem, self.mem = _memberships(nodes)
        self.j = JReplica(jm, slots=slots, max_len=max_len,
                          prefill_chunk=chunk)
        self.j.attach_params(jp)
        self.t = Replica(m, slots=slots, max_len=max_len, prefill_chunk=chunk,
                         device="cpu")
        self.t.attach_params(p)
        self.fused = fused
        self.router = SessionRouter(self.mem)

    def _both(self, fn):
        outs = []
        for rep, req_cls in ((self.j, JRequest), (self.t, Request)):
            try:
                outs.append(("ok", fn(rep, req_cls)))
            except Exception as exc:             # compared, not swallowed
                outs.append(("raised", type(exc).__name__))
        (jk, jv), (tk, tv) = outs
        assert jk == tk, outs
        if jk == "ok":
            assert jv == tv
        self.check()
        return tv if tk == "ok" else None

    def admit(self, sid, prompt):
        return self._both(lambda r, R: r.admit(R(sid, prompt)))

    def begin(self, sid, prompt):
        return self._both(lambda r, R: r.begin_admit(R(sid, prompt)))

    def advance(self):
        return self._both(lambda r, R: r.advance_prefills())

    def evict(self, sid):
        return self._both(lambda r, R: r.evict(sid))

    def decode(self):
        jroute = self.jmem.ring_state.device_bucket_table() \
            if self.fused else None
        route = self.mem.ring_state.device_bucket_table() \
            if self.fused else None
        out = self._both(lambda r, R: r.decode_round(
            route=jroute if r is self.j else route))
        assert self.t.routed_owners == self.j.routed_owners
        if self.fused and self.t.sessions:
            sids = sorted(self.t.sessions)
            assert [self.t.routed_owners[s] for s in sids] \
                == self.router.route(sids)
        else:
            assert self.t.routed_owners == {}
        return out

    def check(self):
        j, t = self.j, self.t
        assert t.sessions == j.sessions
        assert t._free == j._free
        assert sorted(t._pending) == sorted(j._pending)
        assert t.failed_prefills == j.failed_prefills
        for name in ("lengths", "tokens", "active", "key_hi", "key_lo"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        for name in ("k", "v"):
            np.testing.assert_allclose(t.cache[name].numpy(),
                                       np.asarray(j.cache[name]), atol=ATOL,
                                       rtol=0)


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lengths]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("chunk", [8, None])
def test_full_house_and_bucketed_rounds(pair, fused, chunk):
    """4 slots: four sessions decode as a full house (the slab in place,
    inactive rows at position 0), then evictions drop to buckets of 2."""
    cfg = pair[-1]
    ls = _Lockstep(pair, slots=4, max_len=48, chunk=chunk, fused=fused)
    for i, p in enumerate(_prompts(cfg, (3, 8, 13, 21), seed=11)):
        ls.admit(f"c{i}", p)
    for _ in range(3):
        ls.decode()
    ls.evict("c1")
    ls.decode()                        # 3 active of 4: still full house
    ls.evict("c3")
    for _ in range(2):
        ls.decode()                    # 2 active: bucketed gather/scatter
    ls.admit("c4", _prompts(cfg, (5,), seed=12)[0])
    ls.decode()


@pytest.mark.parametrize("fused", [True, False])
def test_overlapped_prefill_lockstep(pair, fused):
    cfg = pair[-1]
    ls = _Lockstep(pair, slots=8, max_len=48, chunk=8, fused=fused)
    sib, ovl, late = _prompts(cfg, (5, 21, 12), seed=13)
    ls.admit("sib", sib)
    assert ls.begin("ovl", ovl) is None
    assert ls.begin("late", late) is None
    while ls.t.num_pending:
        ls.decode()                    # decode overlaps the prefills
        ls.advance()
    for _ in range(3):
        ls.decode()
    ls.evict("sib")
    ls.decode()


def test_failed_pending_prefill_lockstep(pair):
    cfg = pair[-1]
    ls = _Lockstep(pair, slots=4, max_len=48, chunk=8, fused=True)
    good, bad = _prompts(cfg, (7, 9), seed=17)
    ls.begin("good", good)
    ls.begin("bad", bad)
    ls.j._pending["bad"]["prompt"] = None     # poison: chunk slice raises
    ls.t._pending["bad"]["prompt"] = None
    assert set(ls.advance()) == {"good"}
    assert ls.t.failed_prefills == ["bad"]
    ls.decode()


def test_decode_round_refuses_a_session_at_max_len(pair):
    """Deliberate difference: repro's per-slot KV write drops a write at
    position >= max_len; the port raises before any device work, and the
    slot state and the cache stay as they were."""
    cfg = pair[-1]
    ls = _Lockstep(pair, slots=2, max_len=16, chunk=None, fused=False)
    ls.admit("full", _prompts(cfg, (12,), seed=19)[0])
    ls.admit("short", _prompts(cfg, (3,), seed=20)[0])
    for _ in range(3):
        ls.decode()                    # lengths 15 and 6
    t = ls.t
    t.decode_round()                   # "full" writes its last position
    state = {name: getattr(t, name).copy()
             for name in ("lengths", "tokens", "active", "key_hi", "key_lo")}
    cache = {name: c.clone() for name, c in t.cache.items()}
    assert t.lengths[t.sessions["full"]] == 16
    with pytest.raises(RuntimeError, match="max_len 16"):
        t.decode_round()
    for name, want in state.items():
        np.testing.assert_array_equal(getattr(t, name), want)
    for name, want in cache.items():
        assert torch.equal(t.cache[name], want)
    assert t.sessions == {"full": 0, "short": 1}


SIDS = ("a", "b", "c", "d")


def _fuzz_ops(rng, length):
    ops = []
    for _ in range(length):
        r = rng.integers(0, 10)
        sid = SIDS[rng.integers(0, len(SIDS))]
        if r < 5:
            ops.append(("admit", sid, int(rng.integers(1, 7)),
                        bool(rng.integers(0, 3) == 0)))
        elif r < 7:
            ops.append(("evict", sid))
        elif r < 8:
            ops.append(("admit_oversize", sid))
        else:
            ops.append(("decode",))
    return ops


@pytest.mark.parametrize("fused", [True, False])
def test_replica_fuzz_lockstep(pair, fused):
    """test_replica_fuzz.py's interleavings (admits that fail inside
    prefill, oversize rejections, evictions, decode rounds) on both
    packages: identical outcomes and slot state after every op."""
    cfg = pair[-1]
    rng = np.random.default_rng(7 if fused else 8)
    for _ in range(4):
        ls = _Lockstep(pair, slots=3, max_len=24, chunk=None, fused=fused)
        for op in _fuzz_ops(rng, 10):
            if op[0] == "admit":
                _, sid, plen, fail = op
                prompt = np.array(["tok"] * plen, dtype=object) if fail \
                    else (np.arange(plen) % cfg.vocab).astype(np.int32)
                ls.admit(sid, prompt)
            elif op[0] == "admit_oversize":
                ls.admit(op[1], np.zeros(24, np.int32))
            elif op[0] == "evict":
                ls.evict(op[1])
            else:
                ls.decode()
            owned = set(ls.t.sessions.values())
            assert len(owned) + ls.t.num_free == ls.t.slots
            assert not owned & set(ls.t._free)

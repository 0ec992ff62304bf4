"""Tensor-parallel replica groups of the port against repro's, on the CPU
in float32 with the port's weights converted from repro's.

Validation and carving raise and accept where repro's do, with repro's
messages.  A ``TPReplicaGroup`` of 2 or 4 shards (one thread each, every
shard on the CPU) gives repro's single-device prefill and decode logits
within 1e-4 and its greedy tokens exactly, for qwen2.5-3b, qwen3-moe
and deepseek-v2 (MLA) ``smoke()``; each shard holds 1/tp of the KV
cache; per-shard exports are repro's slabs byte for byte.  A tp = 2 (and
tp = 4) ``ServeCluster`` through a node failure, a per-shard handoff and
a partial-group device loss gives repro's tp = 1 tokens; the
subprocess test runs repro's own tp = 2 cluster on 8 forced host
devices (``tests/test_tp.py``'s scenario) and holds the port's tokens
and counters to it.  The guards: a shard that raises propagates its
error and leaves no sibling waiting; the psum adds in shard order; the
entry points want the card unless the caller names the CPU.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.launch.mesh import replica_groups as j_replica_groups
from repro.models import Model as JModel
from repro.models import transformer as jtransformer
from repro.models.tp import validate_tp as j_validate_tp
from repro.runtime import Membership as JMembership
from repro.serve import Request as JRequest
from repro.serve import ServeCluster as JServeCluster
from repro_torch import dht_cluster, tp_cluster
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.build import KernelLaunchError
from repro_torch.launch.mesh import DeviceGroup, replica_groups
from repro_torch.models import Model, transformer
from repro_torch.models.tp import TPReplicaGroup, validate_tp
from repro_torch.runtime import Membership
from repro_torch.serve import Replica, Request, ServeCluster
from repro_torch.sharding import specs

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
B, MAX_LEN, STEPS = 2, 48, 8
POOL = ["cpu"] * 8


def _pair(arch, **over):
    over = {"dtype": "float32", **over}
    jcfg = j_smoke(arch).with_overrides(**over)
    cfg = get_smoke_config(arch).with_overrides(**over)
    jm, m = JModel(jcfg), Model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _raised(fn):
    try:
        fn()
    except Exception as exc:           # noqa: BLE001 - compared below
        return type(exc).__name__, str(exc)
    return None


# ---------------------------------------------------------------------------
# validation and carving
# ---------------------------------------------------------------------------

VALIDATE = [("qwen2.5-3b", {}, tp) for tp in (0, 1, 2, 3, 4)] + [
    ("qwen2.5-3b", {"num_kv_heads": 4}, 4),
    ("qwen2.5-3b", {"vocab": 250}, 4),
    ("qwen2.5-3b", {"d_ff": 130}, 4),
    ("falcon-mamba-7b", {}, 2),
    ("zamba2-7b", {}, 2),
    ("whisper-small", {}, 2),
    ("internvl2-2b", {}, 2),
    ("qwen3-moe-235b-a22b", {}, 2),
    ("qwen3-moe-235b-a22b", {"moe_d_ff": 90}, 4),
    ("deepseek-v2-236b", {}, 4),
    ("deepseek-v2-236b", {"num_kv_heads": 3}, 4),
]


@pytest.mark.parametrize("arch,over,tp", VALIDATE)
def test_validate_tp_raises_and_accepts_where_repro_does(arch, over, tp):
    """The cases of ``tests/test_tp.py``'s validation tests and one for
    each family and divided dimension: the same accept, or the same
    error and message."""
    cfg = get_smoke_config(arch).with_overrides(**over)
    jcfg = j_smoke(arch).with_overrides(**over)
    got = _raised(lambda: validate_tp(cfg, tp))
    assert got == _raised(lambda: j_validate_tp(jcfg, tp))
    want_ok = (arch, over, tp) in (
        ("qwen2.5-3b", {}, 1), ("qwen2.5-3b", {}, 2),
        ("qwen2.5-3b", {"num_kv_heads": 4}, 4),
        ("qwen3-moe-235b-a22b", {}, 2), ("deepseek-v2-236b", {}, 4),
        ("deepseek-v2-236b", {"num_kv_heads": 3}, 4))
    assert (got is None) == want_ok, got


@pytest.mark.parametrize("tp", [0, 1, 2, 3, 4, 8, 16])
def test_replica_groups_carve_a_pool_as_repro_does(tp):
    """``tp`` consecutive entries a group, ids = pool indices; a tp that
    does not divide the pool raises repro's error and message."""
    got = _raised(lambda: replica_groups(POOL, tp))
    jdevs = [jax.devices()[0]] * len(POOL)
    if got is not None:
        assert got == _raised(lambda: j_replica_groups(jdevs, tp))
        assert tp in (0, 3, 16)
        return
    groups = replica_groups(POOL, tp)
    assert len(groups) == len(POOL) // tp
    assert [g.ids for g in groups] == [tuple(range(i, i + tp))
                                      for i in range(0, len(POOL), tp)]
    assert all(d == torch.device("cpu") for g in groups for d in g.devices)


# ---------------------------------------------------------------------------
# one group against repro's single-device model
# ---------------------------------------------------------------------------

GROUPS = [("qwen2.5-3b", {}, 2), ("qwen2.5-3b", {"num_kv_heads": 4}, 4),
          ("qwen3-moe-235b-a22b", {}, 2),
          ("qwen3-moe-235b-a22b", {"num_kv_heads": 4}, 4),
          ("deepseek-v2-236b", {}, 2), ("deepseek-v2-236b", {}, 4)]


@pytest.mark.parametrize("arch,over,tp", GROUPS)
def test_group_decode_matches_repro_single_device(arch, over, tp):
    """Prefill and 8 greedy lockstep steps on a tp-shard group: logits
    within 1e-4 of repro's single-device model and the tokens equal; a
    slot round of one real row plus padding through ``Replica`` gives
    the full round's token; each shard holds 1/tp of k/v (MLA's latent
    cache replicates); chunked prefill's first token, and the per-shard
    exports reassembled equal the full export (KV-block families)."""
    jm, jp, m, p, cfg = _pair(arch, **over)
    g = TPReplicaGroup(m, ["cpu"] * tp)
    sp = g.shard_params(p)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 12,
                                               dtype=np.int32)
    toks_b = np.tile(prompt[None], (B, 1))
    jcache = jm.init_cache(B, MAX_LEN)
    jl, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks_b)},
                                     jcache)
    cache = g.init_cache(B, MAX_LEN)
    logits, cache = g.prefill(sp, {"tokens": torch.from_numpy(toks_b)}, cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL)
    toks = [int(np.argmax(np.asarray(jl)[0]))]
    assert int(torch.argmax(logits[0])) == toks[0]
    jdecode = jax.jit(jm.decode_step)
    n = len(prompt)
    for _ in range(STEPS - 1):
        t = np.full((B, 1), toks[-1], np.int32)
        jl, jcache = jdecode(jp, jcache, jnp.asarray(t), n)
        logits, cache = g.decode_step(sp, cache, torch.from_numpy(t), n)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=ATOL)
        toks.append(int(np.argmax(np.asarray(jl)[0])))
        assert int(torch.argmax(logits[0])) == toks[-1]
        n += 1
    full = m.init_cache(B, MAX_LEN, device="cpu")
    per_shard = g.per_shard_cache_bytes(cache)
    total = sum(t.numel() * t.element_size() for t in full.values())
    assert per_shard == (total if cfg.mla_kv_lora else total // tp)

    # a slot round (bucket 2 = one real row + a padding row) on a group
    # replica gives the same token as a full round of a tp=1 replica
    reps = []
    for group in (None, g):
        rep = Replica(m, slots=4, max_len=MAX_LEN, device="cpu", group=group)
        rep.attach_params(p if group is None else sp)
        first = rep.admit(Request("x", prompt, 4))
        reps.append((first, rep.decode_round(), rep.decode_round()))
    assert reps[0] == reps[1] and reps[0][0] == toks[0]
    if not m.supports_kv_blocks:
        return
    c2 = g.init_cache(B, MAX_LEN)
    l2, c2 = g.prefill_chunk(sp, torch.from_numpy(toks_b), c2, 0)
    assert int(torch.argmax(l2[0, len(prompt) - 1])) == toks[0]
    shards = g.export_kv_shards(cache, 0, 0, 8)
    assert len(shards) == tp
    assert np.array_equal(np.concatenate(shards, axis=3),
                          g.export_kv_block(cache, 0, 0, 8))
    want = jtransformer.export_kv_block_shards(jm.cfg, jcache, 0, 0, 8, tp)
    for got, ref in zip(shards, want):
        np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("kv,shards", [(2, 1), (2, 2), (4, 2), (4, 4),
                                        (2, 3), (4, 0)])
def test_export_kv_block_shards_matches_repro_slab_for_slab(kv, shards):
    """The same float32 cache on both packages: every shard slab equals
    repro's byte for byte; a shard count that does not divide kv_heads
    raises repro's error and message."""
    import jax.numpy as jnp
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(
        dtype="float32", num_kv_heads=kv)
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32",
                                                num_kv_heads=kv)
    rng = np.random.default_rng(kv * 10 + shards)
    shape = transformer.cache_shapes(cfg, 2, 32)["k"]
    host = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    cache = {n: torch.from_numpy(a.copy()) for n, a in host.items()}
    jcache = {n: jnp.asarray(a) for n, a in host.items()}
    got = _raised(lambda: transformer.export_kv_block_shards(
        cfg, cache, 0, 0, 8, shards))
    if got is not None:
        assert got == _raised(lambda: jtransformer.export_kv_block_shards(
            jcfg, jcache, 0, 0, 8, shards))
        return
    for row, off in ((0, 0), (1, 8), (1, 24)):
        mine = transformer.export_kv_block_shards(cfg, cache, row, off, 8,
                                                  shards)
        ref = jtransformer.export_kv_block_shards(jcfg, jcache, row, off, 8,
                                                  shards)
        assert [a.tobytes() for a in mine] == [a.tobytes() for a in ref]
        assert transformer.concat_kv_heads(mine).tobytes() == \
            transformer.export_kv_block(cfg, cache, row, off, 8).tobytes()


# ---------------------------------------------------------------------------
# the cluster against repro's tp = 1 cluster, in process
# ---------------------------------------------------------------------------

def _cluster_run(ns, tp, *, churn=True, prompt_len=40, **kw):
    mem_cls, cluster_cls, req_cls = ns["classes"]
    m = mem_cls(t_q=60.0, now=lambda: 0.0, **ns["kw"])
    for i in range(4):
        m.request_join(f"10.3.0.{i}", 7000 + i)
    cl = cluster_cls(m, ns["model"], ns["params"], slots=8, max_len=64,
                     tp=tp, **kw, **ns["kw"])
    rng = np.random.default_rng(0)
    for i in range(6):
        cl.submit(req_cls(f"s{i}", rng.integers(0, ns["cfg"].vocab,
                                                prompt_len, dtype=np.int32),
                          max_new_tokens=8))
    for _ in range(2):
        cl.step()
    if churn:
        m.fail(cl.sessions["s0"].owner)
        cl.step()
        # the oldest live replica's node goes next: through the loss of
        # one device of its group at tp > 1, as a node failure at tp = 1
        victim = next(iter(cl.replicas))
        if tp > 1:
            node, devs = next(iter(cl.supervisor._groups.items()))
            assert node == victim and cl.lose_device(devs[-1]) == node
        else:
            m.fail(victim)
    cl.run()
    return {s: list(r.generated) for s, r in cl.sessions.items()}, cl.stats()


@pytest.mark.parametrize("arch,over,tp", [
    ("qwen2.5-3b", {}, 2), ("qwen2.5-3b", {"num_kv_heads": 4}, 4),
    ("qwen3-moe-235b-a22b", {}, 2), ("deepseek-v2-236b", {}, 2)])
def test_cluster_through_churn_gives_repros_tp1_tokens(arch, over, tp):
    """4 nodes on the pool of 8 CPU entries, 6 sessions of 40 tokens: a
    node failure (per-shard handoff for the KV-block families) and the
    loss of one device of a live group, against repro's tp = 1 cluster
    that fails the same two nodes (a migrated MoE session re-prefills its
    tail as a chunk, whose expert capacity differs from decode's, so the
    reference must migrate the same sessions): the same tokens; the
    group counters."""
    jm, jp, m, p, cfg = _pair(arch, **over)
    ref = {"classes": (JMembership, JServeCluster, JRequest), "kw": {},
           "model": jm, "params": jp, "cfg": cfg}
    port = {"classes": (Membership, ServeCluster, Request),
            "kw": {"device": "cpu"}, "model": m, "params": p, "cfg": cfg}
    want, _ = _cluster_run(ref, 1)
    got, st = _cluster_run(port, tp, mesh=POOL)
    assert got == want
    assert st["tp"] == tp and st["groups"] == 8 // tp
    assert st["dead_groups"] == 1 and st["migrated"] >= 2
    if m.supports_kv_blocks:
        assert st["handoffs"] >= 1 and st["handoff_misses"] == 0


TP_CLUSTER_REPRO = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, jax, numpy as np
from repro.configs import get_smoke_config
from repro.models import Model
from repro.runtime import Membership
from repro.serve import Request, ServeCluster

cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
model = Model(cfg)
params = model.init(jax.random.PRNGKey(0))

def run(tp, *, lose_device=False, fail_owner=False, nodes=4, prompt_len=10):
    m = Membership(t_q=60.0, now=lambda: 0.0)
    for i in range(nodes):
        m.request_join(f"10.3.0.{i}", 7000 + i)
    cl = ServeCluster(m, model, params, slots=8, max_len=64, tp=tp)
    rng = np.random.default_rng(0)
    reqs = [Request(f"s{i}",
                    rng.integers(0, cfg.vocab, prompt_len, dtype=np.int32),
                    max_new_tokens=8) for i in range(6)]
    for r in reqs:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    if lose_device:
        node, devs = next(iter(cl.supervisor._groups.items()))
        assert cl.lose_device(devs[-1]) == node
    if fail_owner:
        m.fail(cl.sessions["s0"].owner)
    cl.run()
    return {sid: list(rec.generated) for sid, rec in cl.sessions.items()}, \
        cl.stats()

out = {}
for name, tp, kw in json.loads(os.environ["TP_VARIANTS"]):
    toks, st = run(tp, **kw)
    out[name] = {"tokens": toks, "stats": st}
print("RESULT " + json.dumps(out))
"""

VARIANTS = [("base", 1, {}), ("tp2", 2, {}),
            ("tp2_lose_device", 2, {"lose_device": True}),
            ("tp2_nodes5", 2, {"nodes": 5}),
            ("tp1_handoff", 1, {"fail_owner": True, "prompt_len": 40}),
            ("tp2_handoff", 2, {"fail_owner": True, "prompt_len": 40})]


@pytest.mark.slow
def test_port_cluster_matches_repros_tp2_cluster_8dev():
    """repro's tp = 2 cluster on 8 forced host devices (the scenario of
    ``tests/test_tp.py``'s cluster script: plain serving, a partial-group
    device loss, 5 nodes on 4 groups, a per-shard handoff) against the
    port's on a pool of 8 CPU entries, on the same weights: the same
    tokens and the same migrated / handoffs / handoff_misses /
    dead_groups (and every other counter of ``stats()``)."""
    res = subprocess.run(
        [sys.executable, "-c", TP_CLUSTER_REPRO], capture_output=True,
        text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "TP_VARIANTS": json.dumps(VARIANTS)})
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, res.stdout[-2000:] + res.stderr[-4000:]
    ref = json.loads(line[0][len("RESULT "):])
    jm, jp, m, p, cfg = _pair("qwen2.5-3b")
    for name, tp, kw in VARIANTS:
        mem = Membership(t_q=60.0, now=lambda: 0.0, device="cpu")
        for i in range(kw.get("nodes", 4)):
            mem.request_join(f"10.3.0.{i}", 7000 + i)
        cl = ServeCluster(mem, m, p, slots=8, max_len=64, tp=tp, mesh=POOL,
                          device="cpu")
        rng = np.random.default_rng(0)
        for i in range(6):
            cl.submit(Request(f"s{i}", rng.integers(
                0, cfg.vocab, kw.get("prompt_len", 10), dtype=np.int32),
                max_new_tokens=8))
        for _ in range(2):
            cl.step()
        if kw.get("lose_device"):
            node, devs = next(iter(cl.supervisor._groups.items()))
            assert cl.lose_device(devs[-1]) == node
        if kw.get("fail_owner"):
            mem.fail(cl.sessions["s0"].owner)
        cl.run()
        toks = {s: list(r.generated) for s, r in cl.sessions.items()}
        assert toks == ref[name]["tokens"], name
        st = cl.stats()
        for key in ("migrated", "handoffs", "handoff_misses",
                    "dead_groups"):
            assert st.get(key) == ref[name]["stats"].get(key), (name, key)
        assert st == ref[name]["stats"], name


def test_tp_cluster_twin_prints_the_examples_line():
    """``python -m repro_torch.tp_cluster --device cpu`` and
    ``examples/tp_cluster.py`` (8 forced host devices) both pass and
    print the same closing line (the same migrated, handoffs and
    dead_groups)."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.tp_cluster", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    ref = subprocess.run(
        [sys.executable, str(REPO / "examples" / "tp_cluster.py")],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert port.returncode == 0, port.stdout + port.stderr
    assert ref.returncode == 0, ref.stdout + ref.stderr[-3000:]
    assert port.stdout.strip().splitlines()[-1] == \
        ref.stdout.strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group4():
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32",
                                                        num_kv_heads=4)
    return TPReplicaGroup(Model(cfg), ["cpu"] * 4, timeout=20.0)


@pytest.mark.parametrize("where", ["before_psum", "after_psum",
                                   "between_psums"])
def test_a_shard_that_raises_propagates_and_leaves_no_sibling_waiting(
        group4, where):
    """Shard 2 raises before, after or between the psums its siblings
    run: the group raises shard 2's error at once (the barrier is
    aborted, no sibling waits out its timeout), and the next call on the
    same threads runs normally."""
    def fn(i):
        x = torch.full((3,), float(i + 1))
        if i == 2 and where == "before_psum":
            raise ValueError("shard 2 failed")
        x = specs.psum_tp(x)
        if i == 2 and where == "between_psums":
            raise ValueError("shard 2 failed")
        x = specs.psum_tp(x)
        if i == 2 and where == "after_psum":
            raise ValueError("shard 2 failed")
        return x

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 2 failed"):
        group4.map(fn)
    assert time.perf_counter() - t0 < 10.0
    out = group4.map(lambda i: specs.psum_tp(torch.full((3,), float(i + 1))))
    assert all(torch.equal(o, torch.full((3,), 10.0)) for o in out)
    names = [t.name for t in threading.enumerate()]
    assert sum(n.startswith("tp-shard-") for n in names) >= 4


def test_a_device_fault_in_a_shard_propagates_as_itself(group4):
    """A kernel's failed launch in one shard reaches the caller as the
    same ``KernelLaunchError`` (so the serve plane's DEVICE_FAULTS checks
    see it), not as a sibling's broken barrier."""
    def fn(i):
        if i == 0:
            raise KernelLaunchError("decode_attention_tc_launch: CUDA error")
        return specs.psum_tp(torch.ones(2))

    with pytest.raises(KernelLaunchError):
        group4.map(fn)


def test_a_sibling_that_never_arrives_times_the_barrier_out():
    """A shard that skips a psum its siblings run cannot hang them: the
    barrier's timeout breaks it and the group raises."""
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    g = TPReplicaGroup(Model(cfg), ["cpu"] * 2, timeout=0.5)
    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError):
        g.map(lambda i: specs.psum_tp(torch.ones(1)) if i == 0 else None)
    assert time.perf_counter() - t0 < 10.0
    assert g.map(lambda i: float(specs.psum_tp(torch.ones(1)))) == [2.0, 2.0]


def test_psum_adds_in_shard_order_on_every_shard(group4):
    """Whatever order the threads arrive in, every shard gets
    ((x0 + x1) + x2) + x3, bit for bit."""
    vals = [1e8, 1.0, -1e8, 3.25]

    def fn(i):
        time.sleep(0.01 * (3 - i))           # the last shard arrives first
        return specs.psum_tp(torch.tensor([vals[i]], dtype=torch.float32))

    want = torch.tensor([vals[0]], dtype=torch.float32)
    for v in vals[1:]:
        want = want + torch.tensor([v], dtype=torch.float32)
    for out in group4.map(fn):
        assert torch.equal(out, want)


def test_outside_a_group_the_hooks_are_the_identity(group4):
    x = torch.randn(3)
    assert specs.psum_tp(x) is x and specs.tp_axis() is None \
        and specs.tp_index() == 0
    assert group4.map(lambda i: (specs.tp_axis(), specs.tp_index())) == [
        ("model", i) for i in range(4)]


def test_group_threads_run_in_inference_mode(group4):
    """Grad mode is thread-local: each shard thread enters
    ``inference_mode`` itself, whatever the caller's mode."""
    with torch.enable_grad():
        assert group4.map(lambda i: torch.is_inference_mode_enabled()) == \
            [True] * 4


def test_param_split_axes_come_from_the_models_specs():
    """Column-parallel q/k/v (and their biases), row-parallel wo and w2,
    vocab-sharded embedding and head, replicated norms; MoE experts
    replicate while their ff dim splits; MLA's compressions replicate."""
    g = TPReplicaGroup(Model(get_smoke_config("qwen2.5-3b")), ["cpu"] * 2)
    lay = g._param_split["layers"]
    assert lay["attn"] == {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1,
                           "bk": 1, "bv": 1}
    assert lay["mlp"] == {"w1": 2, "w3": 2, "w2": 1}
    assert lay["ln1"] is None and g._param_split["ln_f"] is None
    assert g._param_split["embed"] == {"embedding": 0, "lm_head": 1}
    moe = TPReplicaGroup(Model(get_smoke_config("qwen3-moe-235b-a22b")),
                         ["cpu"] * 2)._param_split["layers"]["moe"]
    assert moe == {"router": None, "w1": 3, "w3": 3, "w2": 2}
    mla = TPReplicaGroup(Model(get_smoke_config("deepseek-v2-236b")),
                         ["cpu"] * 2)
    attn = mla._param_split["layers"]["attn"]
    assert attn["w_dkv"] is None and attn["w_dq"] is None \
        and attn["w_ukv"] == 2 and attn["w_uq"] == 2 and attn["wo"] == 1
    sh = mla._param_split["layers"]["moe"]
    assert sh["sw1"] == 2 and sh["sw2"] == 1 and sh["w1"] == 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the guard "
                    "of a host without a CUDA card")
@pytest.mark.parametrize("entry", ["cluster", "pool", "dht_cluster",
                                   "tp_cluster"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device=`` every new entry point wants the CUDA card and
    raises without one: ``ServeCluster(tp=2)``'s default pool, a pool of
    None, the two twins."""
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    m = Model(cfg)
    calls = {
        "cluster": lambda: ServeCluster(
            Membership(t_q=60.0, now=lambda: 0.0, device="cpu"), m,
            m.init(device="cpu"), tp=2),
        "pool": lambda: replica_groups(None, 1),
        "dht_cluster": lambda: dht_cluster.run(log=lambda *a: None),
        "tp_cluster": lambda: tp_cluster.main([]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_a_device_group_names_its_pool_ids():
    g = TPReplicaGroup(Model(get_smoke_config("qwen2.5-3b")),
                       DeviceGroup((torch.device("cpu"),) * 2, (6, 7)))
    assert g.device_ids() == [6, 7] and g.tp == 2


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-235b-a22b",
                                  "deepseek-v2-236b", "internvl2-2b",
                                  "falcon-mamba-7b", "whisper-small"])
def test_param_pspecs_match_repros_for_the_transformer_families(arch):
    """The logical-axis trees of the transformer families equal repro's,
    int8 experts included; the other families raise (the port names no
    axes for them: tensor parallelism refuses them)."""
    m, jm = Model(get_smoke_config(arch)), JModel(j_smoke(arch))
    if get_smoke_config(arch).family not in ("dense", "moe", "vlm"):
        with pytest.raises(NotImplementedError, match="transformer"):
            m.param_pspecs()
        return
    assert m.param_pspecs() == jm.param_pspecs()
    assert m.cache_pspecs() == jm.cache_pspecs()
    q = "int8" if get_smoke_config(arch).moe_experts else ""
    assert Model(get_smoke_config(arch).with_overrides(
        moe_weight_dtype=q)).param_pspecs() == JModel(j_smoke(arch)
        .with_overrides(moe_weight_dtype=q)).param_pspecs()

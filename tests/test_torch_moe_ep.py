"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) against
repro's ``moe_block_ep`` on the CPU, in float32.

One subprocess runs repro on 8 forced host devices under
``set_mesh(make_host_mesh(M))``: ``jax.jit`` of the block's output and of
``jax.value_and_grad`` of the block and of ``Model.train_loss``, for the
qwen3-moe ``smoke()`` config (silu, ``w3``) and the deepseek-v2 one
(shared experts), at meshes (2, 4) and (4, 2), and for one case whose
router is skewed so that slots drop at both capacities (c2 at the senders,
c3 at the experts' slabs).  The port runs the same weights and inputs on a
pool of 8 CPU entries under ``mesh_context(make_host_mesh(M, pool))``.

Tolerances: the block's output within 1e-5 of its max |y| and the loss
within 1e-5 absolute (the same f32 sums in another order: the combine adds
in choice order where repro scatter-adds); each gradient leaf within 1e-4
of its max |g|.

Also the fallbacks (no mesh, E % M, S % M: ``moe_block`` bit for bit; a
TP group's shard threads, which see no mesh), the refusals (a batch the
data axis does not divide, int8 experts under a mesh), the recomputation
of a remat layer outside the caller's mesh context (the card's autograd
thread), and the mesh and its rules.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model, layers, moe_ep
from repro_torch.sharding import specs as sh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
POOL = ["cpu"] * 8
B, S = 4, 16
OUT_RTOL = 1e-5
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
# (name, arch, model axis, skewed router)
CASES = [("qwen_2x4", "qwen3-moe-235b-a22b", 4, False),
         ("qwen_4x2", "qwen3-moe-235b-a22b", 2, False),
         ("deepseek_2x4", "deepseek-v2-236b", 4, False),
         ("deepseek_4x2", "deepseek-v2-236b", 2, False),
         ("qwen_skewed_2x4", "qwen3-moe-235b-a22b", 4, True)]
CASE_IDS = [c[0] for c in CASES]

REPRO = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.launch.mesh import make_host_mesh
from repro.models import Model
from repro.models.moe_ep import moe_block_ep
from repro.sharding import specs as sh

def flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{pre}/{k}"))
        return out
    return {pre: np.asarray(tree)}

out = {}
for name, arch, m_axis, skew in json.loads(os.environ["MOE_EP_CASES"]):
    cfg = get_smoke_config(arch).with_overrides(dtype="float32",
                                                moe_impl="ep")
    model = Model(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    u = rng.standard_normal(cfg.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    if skew:
        # expert 0 or 1 (shard 0's) takes one choice of every token, by
        # the sign of h . u
        router = np.array(params["layers"]["moe"]["router"])
        router[:, :, 0] += 20 * u
        router[:, :, 1] -= 20 * u
        params["layers"]["moe"]["router"] = router
    batch = {k: rng.integers(0, cfg.vocab, (%(B)d, %(S)d), dtype=np.int32)
             for k in ("tokens", "labels")}
    x = rng.standard_normal((%(B)d, %(S)d, cfg.d_model)).astype(np.float32)
    if skew:
        x += 2 * u          # and mostly expert 0: past c3 at its slab
    r = rng.standard_normal(x.shape).astype(np.float32)
    lp = jax.tree.map(lambda t: t[0], params["layers"]["moe"])
    with sh.mesh_context(make_host_mesh(m_axis)):
        loss, grads = jax.jit(jax.value_and_grad(model.train_loss))(
            params, batch)

        def block(lp, x):
            y = moe_block_ep(lp, x, cfg)
            return jnp.sum(y * r), y
        (_, y), bgrads = jax.jit(jax.value_and_grad(
            block, argnums=(0, 1), has_aux=True))(lp, jnp.asarray(x))
    res = {"loss": np.asarray(loss), "x": x, "r": r, "y": np.asarray(y),
           "dx": np.asarray(bgrads[1])}
    res.update({k: v for k, v in batch.items()})
    res.update({"p" + k: v for k, v in flat(params).items()})
    res.update({"g" + k: v for k, v in flat(grads).items()})
    res.update({"bg" + k: v for k, v in flat(bgrads[0]).items()})
    out[name] = res
np.savez(sys.argv[1], **{f"{c}|{k}": v for c, res in out.items()
                         for k, v in res.items()})
print("MOE_EP_OK")
""" % {"B": B, "S": S}


@pytest.fixture(scope="module")
def repro_runs(tmp_path_factory):
    """repro's results for every case, from one subprocess."""
    path = tmp_path_factory.mktemp("moe_ep") / "repro.npz"
    res = subprocess.run(
        [sys.executable, "-c", REPRO, str(path)], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "JAX_PLATFORMS": "cpu", "MOE_EP_CASES": json.dumps(CASES)})
    assert "MOE_EP_OK" in res.stdout, res.stdout[-2000:] + res.stderr[-4000:]
    runs = {}
    with np.load(path) as f:
        for key in f.files:
            case, name = key.split("|", 1)
            runs.setdefault(case, {})[name] = f[key]
    return runs


def _tree(run, prefix):
    out = {}
    for key, v in run.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def _cfg(arch, **kw):
    return get_smoke_config(arch).with_overrides(dtype="float32",
                                                 moe_impl="ep", **kw)


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _close(got, want, rtol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rtol * scale, (err, scale)


def _with_leaves(tree):
    """``tree`` with each tensor replaced by a fresh leaf that requires
    grad, and those leaves by path."""
    leaves = {}

    def walk(t, pre=""):
        if isinstance(t, dict):
            return {k: walk(v, f"{pre}/{k}") for k, v in t.items()}
        leaves[pre] = t.detach().clone().requires_grad_()
        return leaves[pre]
    return walk(tree), leaves


def _grads(fn, tree):
    """(value, gradient by path) of ``fn(tree)`` by autograd."""
    tree, leaves = _with_leaves(tree)
    val = fn(tree)
    return val, dict(zip(leaves, torch.autograd.grad(val,
                                                     list(leaves.values()))))


@pytest.mark.parametrize("case", CASE_IDS)
def test_block_and_its_gradients_match_repro(repro_runs, case):
    _, arch, m_axis, _ = _case(case)
    run, cfg = repro_runs[case], _cfg(arch)
    lp = {k: v[0].requires_grad_() for k, v in
          _tree(run, "p/layers/moe").items()}
    x = torch.from_numpy(run["x"]).requires_grad_()
    with sh.mesh_context(make_host_mesh(m_axis, POOL)):
        y = moe_ep.moe_block_ep(lp, x, cfg)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(run["r"])),
                                [x, *lp.values()])
    _close(y, run["y"], OUT_RTOL)
    _close(grads[0], run["dx"], GRAD_RTOL)
    assert set(lp) == {k[len("bg/"):] for k in run if k.startswith("bg/")}
    for name, g in zip(lp, grads[1:]):
        _close(g, run["bg/" + name], GRAD_RTOL)


@pytest.mark.parametrize("case", CASE_IDS)
def test_train_loss_and_every_gradient_match_repro(repro_runs, case):
    _, arch, m_axis, _ = _case(case)
    run = repro_runs[case]
    model = Model(_cfg(arch))
    params = _tree(run, "p")
    batch = {k: torch.from_numpy(run[k]) for k in ("tokens", "labels")}
    with sh.mesh_context(make_host_mesh(m_axis, POOL)):
        loss, grads = _grads(lambda p: model.train_loss(p, batch), params)
    assert abs(float(loss.detach()) - float(run["loss"])) <= LOSS_ATOL
    assert set(grads) == {k[1:] for k in run if k.startswith("g/")}
    for name, g in grads.items():
        _close(g, run["g" + name], GRAD_RTOL)


def _shard_ids(x, router, cfg, d_rows, m_shards):
    """Each data row's shards' top-k ids, as the block routes them."""
    return [[moe_ep._route(xj.reshape(-1, x.shape[-1]), router, cfg)[1]
             for xj in row] for row in moe_ep._shards(x, d_rows, m_shards)]


def test_skewed_router_drops_at_both_capacities(repro_runs):
    """The skewed case drops slots past c2 and past c3 in every data row,
    so the parity tests above hold the drops to repro's."""
    run, cfg = repro_runs["qwen_skewed_2x4"], _cfg("qwen3-moe-235b-a22b")
    router = torch.from_numpy(np.array(run["p/layers/moe/router"][0]))
    rows = _shard_ids(torch.from_numpy(run["x"]), router, cfg, 2, 4)
    assert moe_ep.capacities(B // 2 * S // 4, cfg, 4) == (5, 10)
    drops = [moe_ep.dropped_slots(ids, cfg, 4) for ids in rows]
    assert all(d2 > 0 and d3 > 0 for d2, d3 in drops), drops


# ---------------------------------------------------------------------------
# fallbacks and refusals
# ---------------------------------------------------------------------------

def _pair(arch="qwen3-moe-235b-a22b", **kw):
    cfg = _cfg(arch, **kw)
    m = Model(cfg)
    return cfg, m, m.init(torch.Generator().manual_seed(0), device="cpu")


def _x(cfg, b=B, s=S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, cfg.d_model), generator=g)


@pytest.mark.parametrize("pool,s", [(None, S), (["cpu"] * 3, S),
                                    (["cpu"] * 4, 18)],
                         ids=["no_mesh", "experts_mod_model", "seq_mod_model"])
def test_fallbacks_are_moe_block_bit_for_bit(pool, s):
    """Where repro's block falls back (no mesh; E % M; S % M) the port's
    returns None and the layer runs ``moe_block``: the MoE output, the
    loss and its gradients equal the GSPMD model's bit for bit."""
    cfg, m, params = _pair()
    gspmd = Model(cfg.with_overrides(moe_impl="gspmd"))
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = _x(cfg, s=s)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, s),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    ctx = sh.mesh_context(None if pool is None else make_host_mesh(
        len(pool), pool))
    with ctx:
        assert moe_ep.moe_block_ep(lp, x, cfg) is None
        loss, grads = _grads(lambda p: m.train_loss(p, batch), params)
    loss_ref, grads_ref = _grads(lambda p: gspmd.train_loss(p, batch), params)
    assert torch.equal(loss, loss_ref)
    for name in grads:
        assert torch.equal(grads[name], grads_ref[name]), name


def test_a_batch_the_data_axis_does_not_divide_raises():
    """repro's ``shard_map`` raises on such a batch; the port raises
    before any work, and refuses a batch rule other than ``data``."""
    cfg, _, params = _pair()
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    with sh.mesh_context(make_host_mesh(2, POOL)):       # data 4
        with pytest.raises(ValueError, match="does not split"):
            moe_ep.moe_block_ep(lp, _x(cfg, b=6), cfg)
        assert moe_ep.moe_block_ep(lp, _x(cfg, b=8), cfg).shape == (8, S, 64)
    with sh.mesh_context(make_host_mesh(2, POOL), {"batch": None}):
        with pytest.raises(ValueError, match="the batch over None"):
            moe_ep.moe_block_ep(lp, _x(cfg, b=8), cfg)


def test_int8_experts_under_a_mesh_raise():
    """repro's EP products read int8 weights without their scales; the
    port refuses them under a mesh and, without one, falls back to
    ``moe_block``, which applies the scales."""
    cfg, m, _ = _pair(moe_weight_dtype="int8")
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    assert lp["w1"].dtype == torch.int8
    x = _x(cfg)
    assert moe_ep.moe_block_ep(lp, x, cfg) is None
    with sh.mesh_context(make_host_mesh(4, POOL)):
        with pytest.raises(ValueError, match="int8"):
            moe_ep.moe_block_ep(lp, x, cfg)


def test_two_calls_are_bit_equal():
    cfg, _, params = _pair("deepseek-v2-236b")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = _x(cfg)
    with sh.mesh_context(make_host_mesh(4, POOL)):
        a = moe_ep.moe_block_ep(lp, x, cfg)
        b = moe_ep.moe_block_ep(lp, x, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_recomputes_under_the_forwards_mesh(remat):
    """On the card the backward (and a remat layer's recomputation) runs
    in the autograd engine's own thread, which does not see the caller's
    thread-local mesh.  A backward taken after the context has closed
    must still recompute each layer on the EP block: the gradients equal
    those of a backward inside the context."""
    cfg, m, params = _pair(remat=remat)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    mesh = make_host_mesh(4, POOL)
    with sh.mesh_context(mesh):
        _, inside = _grads(lambda p: m.train_loss(p, batch), params)
        tree, leaves = _with_leaves(params)
        loss = m.train_loss(tree, batch)
    assert sh.current_mesh() is None
    outside = dict(zip(leaves, torch.autograd.grad(loss,
                                                   list(leaves.values()))))
    gspmd_loss, _ = _grads(lambda p: Model(cfg.with_overrides(
        moe_impl="gspmd")).train_loss(p, batch), params)
    assert not torch.equal(loss.detach(), gspmd_loss.detach())
    for name in inside:
        assert torch.equal(outside[name], inside[name]), name


def test_top_k_is_read_as_a_module_attribute():
    """The block routes through ``layers._top_k`` looked up at call time,
    so a caller may record and replay the router's choices."""
    cfg, _, params = _pair()
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    calls, real = [], layers._top_k

    def spy(probs, k):
        calls.append(probs.shape)
        return real(probs, k)
    layers._top_k = spy
    try:
        with sh.mesh_context(make_host_mesh(4, POOL)):
            moe_ep.moe_block_ep(lp, _x(cfg), cfg)
    finally:
        layers._top_k = real
    # one call a shard: (data 2) x (model 4), T_loc = 2 x 4 tokens each
    assert calls == [torch.Size([8, cfg.moe_experts])] * 8


def test_a_tp_groups_shards_see_no_mesh_and_fall_back():
    """A TP shard's thread sees no mesh, as a repro shard body sees none:
    a ``moe_impl="ep"`` group's prefill under a mesh (where the block on
    the caller's thread does run EP) equals its prefill without one."""
    from repro_torch.models.tp import TPReplicaGroup
    cfg, m, params = _pair()
    g = TPReplicaGroup(m, ["cpu"] * 2)
    sp = g.shard_params(params)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S), dtype=np.int32))
    ref = g.prefill(sp, {"tokens": tokens}, g.init_cache(B, 32))[0]
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    with sh.mesh_context(make_host_mesh(4, POOL)):
        assert moe_ep.moe_block_ep(lp, _x(cfg), cfg) is not None
        got = g.prefill(sp, {"tokens": tokens}, g.init_cache(B, 32))[0]
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the mesh and its rules
# ---------------------------------------------------------------------------

def test_make_host_mesh_is_repros_grid_and_refusal():
    from repro.launch import mesh as jmesh
    mesh = make_host_mesh(4, POOL)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.entries() == [torch.device("cpu")] * 8
    assert make_host_mesh(pool=["cpu"] * 3).shape == {"data": 3, "model": 1}
    for bad in (3, 0):
        with pytest.raises(ValueError, match=f"model_axis={bad} must be >= 1 "
                           "and divide the 8 available device"):
            make_host_mesh(bad, POOL)
    assert "make_host_mesh" in dir(jmesh)


def test_make_host_mesh_without_a_pool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(1)


def test_mesh_context_filters_rules_and_is_thread_local():
    mesh = make_host_mesh(4, POOL)
    assert sh.current_mesh() is None
    seen = []
    with sh.mesh_context(mesh, {"seq": ("pod", "model")}):
        assert sh.current_mesh() is mesh
        assert sh.logical_spec("batch", "seq", "heads") == ("data", "model",
                                                            None)
        t = threading.Thread(target=lambda: seen.append(sh.current_mesh()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [None]
    assert sh.current_mesh() is None
    assert sh.logical_spec("batch") == (("pod", "data"),)
    sh.set_mesh(mesh)
    try:
        assert sh.logical_spec("batch") == ("data",)
    finally:
        sh.set_mesh(None)
    assert sh.logical_spec("batch") == (("pod", "data"),)


def test_smoke_configs_are_repros():
    for arch in ("qwen3-moe-235b-a22b", "deepseek-v2-236b"):
        j, t = j_smoke(arch), get_smoke_config(arch)
        for f in ("moe_experts", "moe_top_k", "moe_capacity_factor",
                  "moe_shared_experts", "act", "d_model"):
            assert getattr(j, f) == getattr(t, f)

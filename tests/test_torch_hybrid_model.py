"""The port's hybrid family against repro's on zamba2-7b smoke() (Mamba-2
SSD layers, one shared attention block after every second layer) in
float32, with weights converted from repro's ``Model(cfg).init``:
prefill logits, the SSD state and the shared sites' KV cache within
1e-4, 16 greedy decode steps token-identical, and lockstep Replica
rounds (fused and unfused, full house and bucketed, mixed lengths) equal
to repro's Replica.  The prefill attention runs K5's plain version, one
call a shared site; decode runs K3's, one call a site.  And the one place
the two differ on purpose: a prompt longer than ``ssm_chunk`` and not a
multiple of it, which repro refuses and the port takes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.runtime import Membership as JMembership
from repro.serve import Replica as JReplica
from repro.serve import Request as JRequest
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.hybrid import num_shared_sites, param_shapes
from repro_torch.runtime import Membership
from repro_torch.serve import Replica, Request

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 64
ARCH = "zamba2-7b"


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke(ARCH).with_overrides(dtype="float32")
    cfg = get_smoke_config(ARCH).with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n,
                                                dtype=np.int32)


def _assert_cache(tc, jc, rows=slice(None)):
    """The port's flat cache against repro's nested one."""
    for name in ("h", "conv"):
        np.testing.assert_allclose(tc[name][:, rows].numpy(),
                                   np.asarray(jc["state"][name]), atol=ATOL,
                                   rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, rows].numpy(),
                                   np.asarray(jc["attn"][name]), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("s", [7, 16, 32])
def test_prefill_logits_state_and_cache_match(pair, s):
    jm, jp, m, p, cfg = pair
    prompt = np.stack([_prompt(cfg, s, 1), _prompt(cfg, s, 2)])
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)},
                                 jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)},
                       m.init_cache(2, MAX_LEN, device="cpu"))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    g = num_shared_sites(cfg)
    assert g == 2 and tc["k"].shape == jc["attn"]["k"].shape \
        == (g, 2, MAX_LEN, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert tc["h"].shape == jc["state"]["h"].shape \
        and tc["h"].dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache(tc, jc)


def test_sixteen_greedy_steps_match(pair):
    jm, jp, m, p, cfg = pair
    prompt = _prompt(cfg, 16, 3)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)[None]},
                                 jm.init_cache(1, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)[None]},
                       m.init_cache(1, MAX_LEN, device="cpu"))
    jdec = jax.jit(jm.decode_step)
    jt, tt = [int(jnp.argmax(jl[0]))], [int(torch.argmax(tl[0]))]
    for step in range(15):
        idx = len(prompt) + step
        jl, jc = jdec(jp, jc, jnp.asarray([[jt[-1]]], jnp.int32),
                      jnp.asarray(idx, jnp.int32))
        tl, tc = m.decode_step(p, tc, torch.tensor([[tt[-1]]]), idx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jt.append(int(jnp.argmax(jl[0])))
        tt.append(int(torch.argmax(tl[0])))
    assert tt == jt and len(tt) == 16
    _assert_cache(tc, jc)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("slots", [3, 8])
def test_replica_lockstep_rounds_match(pair, fused, slots):
    """3 sessions of 16, 32 and 7 tokens: a full house of 3 slots (the
    slab stepped in place) or 3 of 8 (a bucket of 4 gathered); every
    round steps all rows at the longest session's position, in both
    packages, and gives repro's Replica's tokens, owners and cache."""
    jm, jp, m, p, cfg = pair
    prompts = [_prompt(cfg, n, 20 + n) for n in (16, 32, 7)]
    j = JReplica(jm, slots=slots, max_len=MAX_LEN)
    j.attach_params(jp)
    t = Replica(m, slots=slots, max_len=MAX_LEN, prefill_chunk=16,
                device="cpu")
    assert t.prefill_chunk is None            # a hybrid prefill is whole
    t.attach_params(p)
    jmem = JMembership(t_q=60.0, now=lambda: 0.0)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device="cpu")
    for i in range(3):
        jmem.request_join(f"10.6.0.{i}", 7000 + i)
        mem.request_join(f"10.6.0.{i}", 7000 + i)
    for i, pr in enumerate(prompts):
        assert t.admit(Request(f"z{i}", pr)) == j.admit(JRequest(f"z{i}", pr))
    for _ in range(4):
        jr = jmem.ring_state.device_bucket_table() if fused else None
        tr = mem.ring_state.device_bucket_table() if fused else None
        assert t.decode_round(route=tr) == j.decode_round(route=jr)
        assert t.routed_owners == j.routed_owners
        assert bool(t.routed_owners) == fused
    jc = {"state": j.cache["state"], "attn": j.cache["attn"]}
    _assert_cache(t.cache, jc)


def test_lockstep_rows_attend_over_positions_they_never_wrote(pair):
    """repro's lockstep semantics, kept: after admits of 7 and 32 tokens
    one round writes both rows' K/V at position 32, so the 7-token row's
    positions 7..31 stay zero and its attention spans them too."""
    _, _, m, p, cfg = pair
    rep = Replica(m, slots=2, max_len=MAX_LEN, device="cpu")
    rep.attach_params(p)
    rep.admit(Request("short", _prompt(cfg, 7, 1)))
    rep.admit(Request("long", _prompt(cfg, 32, 2)))
    rep.decode_round()
    short = rep.sessions["short"]
    k = rep.cache["k"][:, short]                 # (G, S, Hkv, hd)
    assert k[:, :7].abs().amax() > 0 and k[:, 32].abs().amax() > 0
    assert not k[:, 7:32].any() and not k[:, 33:].any()
    assert rep.lengths[short] == 8               # its own count moves by one


def test_prompt_off_the_chunk_grid(pair):
    """S = 20 with ssm_chunk 16: repro's SSD keeps 16 positions and fails
    to broadcast against the 20-position skip term; the port runs a
    remainder chunk of 4, equal to stepping the 20 tokens one by one
    (decode attention over the KV written so far)."""
    jm, jp, m, p, cfg = pair
    prompt = _prompt(cfg, 20, 4)
    with pytest.raises(TypeError):
        jm.prefill(jp, {"tokens": jnp.asarray(prompt)[None]},
                   jm.init_cache(1, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)[None]},
                       m.init_cache(1, MAX_LEN, device="cpu"))
    cache = m.init_cache(1, MAX_LEN, device="cpu")
    for i, tok in enumerate(prompt):
        sl, cache = m.decode_step(p, cache, torch.tensor([[int(tok)]]), i)
    np.testing.assert_allclose(tl.numpy(), sl.numpy(), atol=ATOL, rtol=0)
    for name in ("h", "conv", "k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), cache[name].numpy(),
                                   atol=ATOL, rtol=0)


def test_one_attention_call_a_shared_site(pair, monkeypatch):
    """A prefill calls K5 (its plain version here) once a shared site, at
    the full prompt; a lockstep decode step calls K3 once a site."""
    _, _, m, p, cfg = pair
    flash, decode = [], []
    real_f, real_d = fa_ops.flash_attention_ref, \
        da_ops.decode_attention_ref
    monkeypatch.setattr(fa_ops, "flash_attention_ref",
                        lambda q, *a, **kw: flash.append(q.shape)
                        or real_f(q, *a, **kw))
    monkeypatch.setattr(da_ops, "decode_attention_ref",
                        lambda q, *a: decode.append(q.shape)
                        or real_d(q, *a))
    cache = m.init_cache(2, MAX_LEN, device="cpu")
    prompt = torch.from_numpy(np.stack([_prompt(cfg, 24, 5),
                                        _prompt(cfg, 24, 6)]))
    _, cache = m.prefill(p, {"tokens": prompt}, cache)
    g, h, hd = num_shared_sites(cfg), cfg.num_heads, cfg.resolved_head_dim
    assert flash == [(2, 24, h, hd)] * g and decode == []
    m.decode_step(p, cache, prompt[:, :1], 24)
    assert decode == [(2, h, hd)] * g and len(flash) == g


def test_mamba2_without_the_shared_block_matches():
    """A Mamba-2 stack with no shared block (falcon-mamba-7b smoke() with
    mamba_version 2): prefill and a decode step equal repro's."""
    over = dict(dtype="float32", mamba_version=2, ssm_head_dim=16)
    jm = JModel(j_smoke("falcon-mamba-7b").with_overrides(**over))
    m = Model(get_smoke_config("falcon-mamba-7b").with_overrides(**over))
    jp = jm.init(jax.random.PRNGKey(2))
    p = m.load(jax.device_get(jp), device="cpu")
    prompt = _prompt(m.cfg, 32, 7)[None]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)},
                        jm.init_cache(1, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)},
                       m.init_cache(1, MAX_LEN, device="cpu"))
    assert set(tc) == {"h", "conv"}
    jl, jc = jm.decode_step(jp, jc, jnp.asarray([[3]], jnp.int32),
                            jnp.asarray(32, jnp.int32))
    tl, tc = m.decode_step(p, tc, torch.tensor([[3]]), 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("h", "conv"):
        np.testing.assert_allclose(tc[name].numpy(),
                                   np.asarray(jc["state"][name]), atol=ATOL,
                                   rtol=0)


def test_param_shapes_are_repros_at_full_size():
    """zamba2-7b's full tree, shape for shape, against repro's abstract
    parameters: 81 Mamba-2 layers (112 heads of 64, state 64) and the
    shared block at head dim 112, 6,751,130,832 parameters in all."""
    jshapes = JModel(j_config(ARCH)).abstract_params()
    cfg = get_config(ARCH)
    shapes = param_shapes(cfg)

    def walk(j, t, path):
        if isinstance(t, dict):
            assert set(j) == set(t), path
            return sum(walk(j[k], t[k], f"{path}/{k}") for k in t)
        assert tuple(j.shape) == tuple(t), path
        return int(np.prod(t))
    assert walk(jshapes, shapes, "") == 6_751_130_832
    assert cfg.resolved_head_dim == 112 and num_shared_sites(cfg) == 14
    assert shapes["layers"]["mamba"]["A_log"] == (81, 112)


def test_init_draws_repro_distributions():
    cfg = get_smoke_config(ARCH).with_overrides(d_model=256)
    m = Model(cfg)
    params = m.init(torch.Generator(device="cpu").manual_seed(3),
                    device="cpu")

    def walk(t, s):
        if isinstance(s, dict):
            assert set(t) == set(s)
            for k in s:
                walk(t[k], s[k])
        else:
            assert tuple(t.shape) == s and t.dtype == torch.bfloat16
    walk(params, param_shapes(cfg))
    mb = params["layers"]["mamba"]
    assert torch.all(mb["A_log"] == 0) and torch.all(mb["norm_w"] == 1)
    assert torch.all(mb["D"] == 1) and torch.all(mb["conv_b"] == 0)
    sh = params["shared"]
    assert torch.all(sh["ln1"] == 1) and torch.all(sh["ln2"] == 1)
    for w in (mb["in_proj"], sh["attn"]["wq"], sh["mlp"]["w2"]):
        assert abs(w.float().std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    m2 = Model(cfg)
    again = m2.init(torch.Generator(device="cpu").manual_seed(3),
                    device="cpu")
    assert torch.equal(again["shared"]["mlp"]["w3"], sh["mlp"]["w3"])


def test_load_rejects_a_foreign_tree(pair):
    jm, jp, m, _, _ = pair
    tree = jax.device_get(jp)
    tree["shared"]["attn"].pop("wq")
    with pytest.raises(ValueError, match="shared/attn"):
        m.load(tree, device="cpu")
    tree = jax.device_get(jp)
    tree.pop("shared")
    with pytest.raises(ValueError, match="params"):
        m.load(tree, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**jax.device_get(jp), "ln_f": np.ones(3)}, m.cfg,
                        "cpu")

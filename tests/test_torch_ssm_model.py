"""The port's Mamba-1 SSM family against repro's on falcon-mamba-7b
smoke() in float32, with weights converted from repro's
``Model(cfg).init``: prefill logits and the h and conv state within
1e-4, 16 greedy decode steps token-identical, lockstep Replica rounds
(fused and unfused, full house and bucketed) equal to a lockstep loop of
repro's ``Model.prefill``/``decode_step``.  The prefill scan runs K6's
plain version.  And the one place the two differ on purpose: a prompt
longer than ``ssm_chunk`` and not a multiple of it, which repro refuses
and the port scans whole."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.hybrid import param_shapes
from repro_torch.runtime import Membership
from repro_torch.serve import Replica, Request

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 64


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke("falcon-mamba-7b").with_overrides(dtype="float32")
    cfg = get_smoke_config("falcon-mamba-7b").with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n,
                                                dtype=np.int32)


def _assert_state(tc, jc):
    for name in ("h", "conv"):
        np.testing.assert_allclose(tc[name].numpy(),
                                   np.asarray(jc["state"][name]), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("s", [16, 32])
def test_prefill_logits_and_state_match(pair, s):
    jm, jp, m, p, cfg = pair
    prompt = np.stack([_prompt(cfg, s, 1), _prompt(cfg, s, 2)])
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)},
                                 jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)},
                       m.init_cache(2, MAX_LEN, device="cpu"))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    assert tc["h"].shape == jc["state"]["h"].shape
    assert tc["conv"].shape == jc["state"]["conv"].shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_state(tc, jc)


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
    _assert_state(tc, jc)


def _repro_lockstep(jm, jp, prompts, rounds):
    """repro's lockstep decode by hand: each prompt prefilled on a
    one-row cache, the rows stacked, then ``rounds`` decode steps at the
    longest length."""
    firsts, caches = [], []
    for pr in prompts:
        logits, c = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(pr)[None]},
                                        jm.init_cache(1, MAX_LEN))
        firsts.append(int(jnp.argmax(logits[0])))
        caches.append(c)
    cache = jax.tree.map(lambda *cs: jnp.concatenate(cs, axis=1), *caches)
    tok = np.array(firsts, np.int32)
    index = max(len(pr) for pr in prompts)
    streams = [[t] for t in firsts]
    for _ in range(rounds):
        logits, cache = jax.jit(jm.decode_step)(
            jp, cache, jnp.asarray(tok)[:, None], jnp.asarray(index, jnp.int32))
        tok = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
        for s, t in zip(streams, tok):
            s.append(int(t))
        index += 1
    return streams, cache


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("slots", [3, 8])
def test_replica_lockstep_rounds_match(pair, fused, slots):
    """3 sessions: a full house of 3 slots (the slab stepped in place),
    or 3 of 8 (a bucket of 4 gathered, padding rows at state 0)."""
    jm, jp, m, p, cfg = pair
    prompts = [_prompt(cfg, n, 20 + n) for n in (16, 32, 16)]
    want, jcache = _repro_lockstep(jm, jp, prompts, rounds=4)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device="cpu")
    for i in range(3):
        mem.request_join(f"10.5.0.{i}", 7000 + i)
    rep = Replica(m, slots=slots, max_len=MAX_LEN, prefill_chunk=16,
                  device="cpu")
    assert rep.prefill_chunk is None          # an SSM prefill is whole
    rep.attach_params(p)
    got = [[rep.admit(Request(f"s{i}", pr))] for i, pr in enumerate(prompts)]
    for _ in range(4):
        route = mem.ring_state.device_bucket_table() if fused else None
        out = rep.decode_round(route=route)
        for i, stream in enumerate(got):
            stream.append(out[f"s{i}"])
        assert bool(rep.routed_owners) == fused
    assert got == want
    for name in ("h", "conv"):
        np.testing.assert_allclose(
            rep.cache[name][:, :3].numpy(),
            np.asarray(jcache["state"][name]), atol=ATOL, rtol=0)
    if slots > 3:
        assert not rep.cache["h"][:, 3:].any()    # padding never written


def test_prompt_off_the_chunk_grid(pair):
    """S = 20 with ssm_chunk 16: repro's chunked scan keeps 16 positions
    and fails to broadcast against the 20-position gate; the port scans
    all 20, equal to stepping the 20 tokens one by one."""
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
    for name in ("h", "conv"):
        np.testing.assert_allclose(tc[name].numpy(), cache[name].numpy(),
                                   atol=ATOL, rtol=0)


def test_prefill_runs_one_scan_per_layer(pair, monkeypatch):
    _, _, m, p, cfg = pair
    calls = []
    real = ssm_ops.ssm_scan_ref
    monkeypatch.setattr(ssm_ops, "ssm_scan_ref",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    m.prefill(p, {"tokens": torch.from_numpy(_prompt(cfg, 24, 5))[None]},
              m.init_cache(1, MAX_LEN, device="cpu"))
    din = cfg.ssm_expand * cfg.d_model
    assert calls == [(1, 24, din)] * cfg.num_layers


def test_init_draws_repro_distributions():
    cfg = get_smoke_config("falcon-mamba-7b").with_overrides(d_model=256)
    m = Model(cfg)
    params = m.init(torch.Generator(device="cpu").manual_seed(3),
                    device="cpu")
    shapes = param_shapes(cfg)

    def walk(t, s):
        if isinstance(s, dict):
            assert set(t) == set(s)
            for k in s:
                walk(t[k], s[k])
        else:
            assert tuple(t.shape) == s and t.dtype == torch.bfloat16
    walk(params, shapes)
    mb = params["layers"]["mamba"]
    n = cfg.ssm_state
    want_a = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    assert torch.equal(mb["A_log"][1, 5], want_a.to(torch.bfloat16))
    assert torch.all(mb["D"] == 1) and torch.all(mb["conv_b"] == 0)
    assert torch.all(mb["dt_bias"].float()
                     == torch.tensor(np.log(np.expm1(0.01))).bfloat16().float())
    assert torch.all(params["layers"]["ln"] == 1)
    for name in ("in_proj", "x_proj", "out_proj", "conv_w"):
        std = mb[name].float().std().item()
        assert abs(std * cfg.d_model ** 0.5 - 1.0) < 0.05, name
    assert abs(params["embed"]["lm_head"].float().std().item() / 0.02
               - 1.0) < 0.05
    assert not torch.equal(mb["in_proj"][0], mb["in_proj"][1])


def test_full_config_counts_repro_parameters():
    """repro's ``param_count`` formula says 7,271,878,656; the tree holds
    786,432 more: per layer it counts two norms where a Mamba layer has
    one, and leaves out conv_b and dt_bias (d_inner each)."""
    cfg = get_config("falcon-mamba-7b")
    assert cfg.param_count() == 7_271_878_656
    leaves = []

    def walk(s):
        if isinstance(s, dict):
            for v in s.values():
                walk(v)
        else:
            leaves.append(int(np.prod(s)))
    walk(param_shapes(cfg))
    din = cfg.ssm_expand * cfg.d_model
    assert sum(leaves) == cfg.param_count() \
        + cfg.num_layers * (2 * din - cfg.d_model) == 7_272_665_088


def test_load_rejects_a_foreign_tree(pair):
    jm, jp, m, _, _ = pair
    tree = jax.device_get(jp)
    tree["layers"]["mamba"].pop("D")
    with pytest.raises(ValueError, match="mamba"):
        m.load(tree, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**jax.device_get(jp), "ln_f": np.ones(3)}, m.cfg,
                        "cpu")


@pytest.mark.parametrize("override", [
    dict(family="encdec"), dict(family="vlm"),
    dict(family="dense", num_heads=4, num_kv_heads=4, mla_kv_lora=32),
    dict(family="moe", num_heads=4, num_kv_heads=4, moe_experts=4,
         moe_top_k=2, moe_d_ff=32, moe_impl="ep")])
def test_unported_variants_raise(override):
    """Only the expert-parallel MoE still raises, naming its ROADMAP item;
    the encoder-decoder, the VLM and MLA are ported and build."""
    cfg = get_smoke_config("falcon-mamba-7b").with_overrides(**override)
    if cfg.moe_impl == "ep":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(cfg)
    else:
        assert Model(cfg).supports_per_slot_decode \
            == (cfg.family != "encdec")

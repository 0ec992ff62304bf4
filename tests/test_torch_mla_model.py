"""The port's MLA family against repro's on deepseek-v2-236b smoke() (MLA
with q through a low-rank pair, and with ``mla_q_lora = 0``, q through
``wq``; 8 experts top 2 with a shared expert) in float32, weights
converted from repro's ``Model(cfg).init``: prefill logits and the latent
``c`` / ``r`` cache within 1e-4, 16 greedy absorbed-decode steps
token-identical, per-slot decode at mixed lengths, whole-prompt admits and
decode rounds on a Replica equal to repro's Replica.  Then the layer
alone, one K5 call a layer in a prefill (q . k over qk_nope + qk_rope
columns, v narrower) and none in decode, no chunked prefill, the full
config's tree, and one absorbed decode step in bf16 (the port's f32
scores from upcast operands) against repro's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.runtime import Membership as JMembership
from repro.serve import Replica as JReplica
from repro.serve import Request as JRequest
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models.transformer import param_shapes
from repro_torch.runtime import Membership
from repro_torch.serve import Replica, Request

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 48
ARCH = "deepseek-v2-236b"
VARIANTS = {"q_lora": {}, "no_q_lora": {"mla_q_lora": 0}}


_PAIRS = {}


def _pair(variant):
    if variant not in _PAIRS:
        over = dict(dtype="float32", **VARIANTS[variant])
        jm = JModel(j_smoke(ARCH).with_overrides(**over))
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = get_smoke_config(ARCH).with_overrides(**over)
        m = Model(cfg)
        _PAIRS[variant] = (jm, jp, m, m.load(jax.device_get(jp),
                                             device="cpu"), cfg)
    return _PAIRS[variant]


@pytest.fixture(params=sorted(VARIANTS))
def pair(request):
    """Both variants: the parity of prefill, greedy decode and the layer."""
    return _pair(request.param)


@pytest.fixture
def pair_q():
    """The config as published (q through ``w_dq`` / ``w_uq``): the serve
    path's tests."""
    return _pair("q_lora")


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n,
                                                dtype=np.int32)


def test_q_goes_through_the_configured_path(pair):
    _, jp, _, p, cfg = pair
    attn = p["layers"]["attn"]
    assert ("w_dq" in attn and "w_uq" in attn) == bool(cfg.mla_q_lora)
    assert ("wq" in attn) == (not cfg.mla_q_lora)
    assert set(attn) == set(jp["layers"]["attn"])


def test_prefill_logits_and_latent_cache_match(pair):
    jm, jp, m, p, cfg = pair
    prompt = np.stack([_prompt(cfg, 13, 1), _prompt(cfg, 13, 2)])
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)},
                                 jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)},
                       m.init_cache(2, MAX_LEN, device="cpu"))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    assert set(tc) == set(jc) == {"c", "r"}
    assert tc["c"].shape == (cfg.num_layers, 2, MAX_LEN, cfg.mla_kv_lora)
    assert tc["r"].shape == (cfg.num_layers, 2, MAX_LEN, cfg.mla_qk_rope_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("c", "r"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


def test_sixteen_greedy_absorbed_decode_steps_match(pair):
    jm, jp, m, p, cfg = pair
    prompt = _prompt(cfg, 9, 3)
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
    for name in ("c", "r"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


def test_per_slot_decode_at_mixed_lengths_matches(pair_q):
    jm, jp, m, p, cfg = pair_q
    assert m.supports_per_slot_decode
    lengths = [3, 11, 7]
    jc, tc = jm.init_cache(3, MAX_LEN), m.init_cache(3, MAX_LEN, device="cpu")
    for row, n in enumerate(lengths):
        prompt = _prompt(cfg, n, 10 + row)
        _, one = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)[None]},
                                     jm.init_cache(1, MAX_LEN))
        jc = jax.tree.map(lambda c, o, r=row: c.at[:, r:r + 1].set(o), jc, one)
        _, tone = m.prefill(p, {"tokens": torch.from_numpy(prompt)[None]},
                            m.init_cache(1, MAX_LEN, device="cpu"))
        for name in ("c", "r"):
            tc[name][:, row] = tone[name][:, 0]
    tok = np.array([[5], [17], [200]], np.int32)
    idx = np.asarray(lengths, np.int32)
    for _ in range(3):
        jl, jc = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(tok),
                                         jnp.asarray(idx))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(tok),
                               torch.from_numpy(idx))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        assert (tok[:, 0] == torch.argmax(tl, dim=-1).numpy()).all()
        idx = idx + 1
    for name in ("c", "r"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_whole_prompt_admits_and_rounds_match_repros_replica(pair_q, fused):
    """Prompts of 21, 5 and 16 tokens admitted whole (MLA has no chunked
    prefill, so the replica drops its ``prefill_chunk``, as repro's), then
    per-slot absorbed-decode rounds in a bucket of 4 of 6 slots: repro's
    first tokens, streams, owners and latent cache."""
    jm, jp, m, p, cfg = pair_q
    j = JReplica(jm, slots=6, max_len=MAX_LEN, prefill_chunk=8)
    j.attach_params(jp)
    t = Replica(m, slots=6, max_len=MAX_LEN, prefill_chunk=8, device="cpu")
    t.attach_params(p)
    assert t.prefill_chunk is None and j.prefill_chunk is None
    jmem = JMembership(t_q=60.0, now=lambda: 0.0)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device="cpu")
    for i in range(3):
        jmem.request_join(f"10.8.0.{i}", 7000 + i)
        mem.request_join(f"10.8.0.{i}", 7000 + i)
    for i, n in enumerate((21, 5, 16)):
        pr = _prompt(cfg, n, 40 + n)
        assert t.admit(Request(f"d{i}", pr)) == j.admit(JRequest(f"d{i}", pr))
    for _ in range(4):
        jr = jmem.ring_state.device_bucket_table() if fused else None
        tr = mem.ring_state.device_bucket_table() if fused else None
        assert t.decode_round(route=tr) == j.decode_round(route=jr)
        assert t.routed_owners == j.routed_owners
    for name in ("c", "r"):
        np.testing.assert_allclose(t.cache[name].numpy(),
                                   np.asarray(j.cache[name]), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("s", [1, 12])
def test_mla_attention_alone_matches_repro(pair, s):
    """Layer 0's ``mla_attention`` without a cache (a train-style pass:
    K5 over the expanded K/V) on random inputs."""
    jm, jp, m, p, cfg = pair
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s))
    jparams = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want, _ = JL.mla_attention(jparams, jnp.asarray(x), jm.cfg,
                               positions=jnp.asarray(pos))
    got, _ = L.mla_attention({k: t[0] for k, t in p["layers"]["attn"].items()},
                             torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_prefill_runs_k5_a_layer_and_decode_runs_no_kernel(pair_q,
                                                           monkeypatch):
    """A prefill calls K5 once a layer, with q and k at qk_nope + qk_rope
    columns, v at v_head_dim, every head its own kv head, causal; the
    absorbed decode calls neither K5 nor K3."""
    _, _, m, p, cfg = pair_q
    calls = []
    real_flash, real_decode = L._flash_op, L._decode_op
    monkeypatch.setattr(L, "_flash_op", lambda q, k, v, causal: calls.append(
        ("K5", q.shape, k.shape, v.shape, causal)) or real_flash(
            q, k, v, causal=causal))
    monkeypatch.setattr(L, "_decode_op", lambda *a: calls.append(("K3",))
                        or real_decode(*a))
    cache = m.init_cache(1, MAX_LEN, device="cpu")
    _, cache = m.prefill(p, {"tokens": torch.from_numpy(_prompt(cfg, 10, 5))
                             [None]}, cache)
    h, dqk = cfg.num_heads, cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim
    assert calls == [("K5", (1, 10, h, dqk), (1, 10, h, dqk),
                      (1, 10, h, cfg.mla_v_head_dim), True)] * cfg.num_layers
    calls.clear()
    m.decode_step(p, cache, torch.tensor([[3]]), 10)
    m.decode_step(p, cache, torch.tensor([[3]]), torch.tensor([11]))
    assert calls == []


def test_no_chunked_prefill(pair_q):
    _, _, m, p, _ = pair_q
    assert not m.supports_chunked_prefill
    with pytest.raises(NotImplementedError, match="chunked"):
        m.prefill_chunk(p, torch.zeros((1, 8), dtype=torch.int32),
                        m.init_cache(1, MAX_LEN, device="cpu"), 0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_shapes_are_repros_at_full_size(variant):
    """deepseek-v2-236b's full tree, shape for shape, against repro's
    abstract parameters: 60 layers of MLA (kv_lora 512, q_lora 1536 or
    none, heads of 128 + 64 q . k and 128 v columns) and 160 experts top
    6 with 2 shared; the parameter count ``configs.base`` gives."""
    over = VARIANTS[variant]
    jshapes = JModel(j_config(ARCH).with_overrides(**over)).abstract_params()
    cfg = get_config(ARCH).with_overrides(**over)
    shapes = param_shapes(cfg)

    def walk(j, t, path):
        if isinstance(t, dict):
            assert set(j) == set(t), path
            return sum(walk(j[k], t[k], f"{path}/{k}") for k in t)
        assert tuple(j.shape) == tuple(t), path
        return int(np.prod(t))
    assert walk(jshapes, shapes, "") == cfg.param_count()
    attn = shapes["layers"]["attn"]
    assert attn["w_dkv"] == (60, 5120, 512 + 64)
    assert attn["w_ukv"] == (60, 512, 128 * (128 + 128))
    assert attn["wo"] == (60, 128 * 128, 5120)
    if cfg.mla_q_lora:
        assert attn["w_uq"] == (60, 1536, 128 * 192)
    else:
        assert attn["wq"] == (60, 5120, 128 * 192)


def test_absorbed_decode_step_in_bf16_matches_repro():
    """A deliberate dtype step: where repro takes ``preferred_element_type
    =f32`` for the scores against the latent cache, the port upcasts the
    bf16 operands (q_c, q_rope, c, r) exactly and multiplies in f32; q_c,
    p and the outputs stay bf16 as in repro.  One layer's absorbed decode
    step over a 20-position cache in bf16, against repro's: the output in
    bf16, within 2e-2 of max |out|, and the in-place cache writes equal."""
    over = dict(dtype="bfloat16")
    jcfg = j_smoke(ARCH).with_overrides(**over)
    cfg = get_smoke_config(ARCH).with_overrides(**over)
    lp = JL.mla_params(jcfg, jax.random.PRNGKey(2))
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in jax.device_get(lp).items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((3, 20, cfg.mla_kv_lora)).astype(np.float32)
    r = rng.standard_normal((3, 20, cfg.mla_qk_rope_dim)).astype(np.float32)
    idx = np.array([4, 19, 11], np.int32)
    bf = jnp.bfloat16
    want, (jc, jr) = jax.jit(lambda *a: JL.mla_attention(
        a[0], a[1], jcfg, positions=a[2], cache=a[3:5], cache_index=a[5]))(
        lp, jnp.asarray(x, bf), jnp.asarray(idx)[:, None],
        jnp.asarray(c, bf), jnp.asarray(r, bf), jnp.asarray(idx))
    tc, tr = (torch.from_numpy(a).to(torch.bfloat16) for a in (c, r))
    got, _ = L.mla_attention(tp, torch.from_numpy(x).to(torch.bfloat16), cfg,
                             positions=torch.from_numpy(idx)[:, None].long(),
                             cache=(tc, tr),
                             cache_index=torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(tc.float().numpy(),
                                  np.asarray(jc.astype(jnp.float32)))
    np.testing.assert_array_equal(tr.float().numpy(),
                                  np.asarray(jr.astype(jnp.float32)))

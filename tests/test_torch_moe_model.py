"""The port's MoE family against repro's on qwen3-moe-235b-a22b smoke()
(8 experts, top 2) in float32, with its expert weights in the working
dtype and quantized to int8 with per-expert scales, and weights converted
from repro's ``Model(cfg).init``: prefill logits and the KV cache within
1e-4, 16 greedy decode steps token-identical, per-slot decode at mixed
lengths, and chunked admits on a Replica equal to repro's chunked admits
(capacity depends on the segment, so a chunked admit is held to repro's
chunked admit, not to a whole prefill).  Then ``moe_block`` alone on
inputs that overflow the experts' capacity, top-k's order on ties, and
the full config's tree."""
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
ARCH = "qwen3-moe-235b-a22b"
VARIANTS = {"experts_f32": {}, "experts_int8": {"moe_weight_dtype": "int8"}}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    over = dict(dtype="float32", **VARIANTS[request.param])
    jcfg = j_smoke(ARCH).with_overrides(**over)
    cfg = get_smoke_config(ARCH).with_overrides(**over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n,
                                                dtype=np.int32)


def test_prefill_logits_and_cache_match(pair):
    jm, jp, m, p, cfg = pair
    prompt = np.stack([_prompt(cfg, 13, 1), _prompt(cfg, 13, 2)])
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)},
                                 jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)},
                       m.init_cache(2, MAX_LEN, device="cpu"))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


def test_sixteen_greedy_steps_match(pair):
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


def test_per_slot_decode_at_mixed_lengths_matches(pair):
    jm, jp, m, p, cfg = pair
    assert m.supports_per_slot_decode and m.supports_chunked_prefill
    lengths = [3, 11, 7]
    jc, tc = jm.init_cache(3, MAX_LEN), m.init_cache(3, MAX_LEN, device="cpu")
    for row, n in enumerate(lengths):
        prompt = _prompt(cfg, n, 10 + row)
        _, one = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)[None]},
                                     jm.init_cache(1, MAX_LEN))
        jc = jax.tree.map(lambda c, o, r=row: c.at[:, r:r + 1].set(o), jc, one)
        _, tone = m.prefill(p, {"tokens": torch.from_numpy(prompt)[None]},
                            m.init_cache(1, MAX_LEN, device="cpu"))
        for name in ("k", "v"):
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


@pytest.mark.parametrize("fused", [True, False])
def test_chunked_admits_match_repros_chunked_admits(pair, fused):
    """Prompts of 21, 5 and 16 tokens admitted in segments of 8 (the last
    one right-padded, and the padding takes capacity too), then per-slot
    decode rounds in a bucket of 4 of 6 slots: repro's Replica's first
    tokens, streams, owners and KV cache."""
    jm, jp, m, p, cfg = pair
    j = JReplica(jm, slots=6, max_len=MAX_LEN, prefill_chunk=8)
    j.attach_params(jp)
    t = Replica(m, slots=6, max_len=MAX_LEN, prefill_chunk=8, device="cpu")
    t.attach_params(p)
    assert t.prefill_chunk == 8
    jmem = JMembership(t_q=60.0, now=lambda: 0.0)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device="cpu")
    for i in range(3):
        jmem.request_join(f"10.7.0.{i}", 7000 + i)
        mem.request_join(f"10.7.0.{i}", 7000 + i)
    for i, n in enumerate((21, 5, 16)):
        pr = _prompt(cfg, n, 30 + n)
        assert t.admit(Request(f"m{i}", pr)) == j.admit(JRequest(f"m{i}", pr))
    for _ in range(4):
        jr = jmem.ring_state.device_bucket_table() if fused else None
        tr = mem.ring_state.device_bucket_table() if fused else None
        assert t.decode_round(route=tr) == j.decode_round(route=jr)
        assert t.routed_owners == j.routed_owners
    for name in ("k", "v"):
        np.testing.assert_allclose(t.cache[name].numpy(),
                                   np.asarray(j.cache[name]), atol=ATOL,
                                   rtol=0)


def _moe_inputs(cfg, b, s, seed, skew):
    """x and the router, with ``skew`` added to two experts' router
    columns so most tokens pick them and overflow their capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.moe_experts))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    router[:, :2] += skew * x.mean(axis=(0, 1))[:, None] \
        / np.square(x.mean(axis=(0, 1))).sum()
    return x, router


@pytest.mark.parametrize("skew", [0.0, 4.0])
@pytest.mark.parametrize("b,s", [(2, 24), (3, 1)])
def test_moe_block_drops_like_repro(pair, b, s, skew):
    """``moe_block`` alone on repro's layer-0 experts and a router that,
    with ``skew``, sends most tokens to two experts: equal outputs, and
    (where S > 1) the inputs do overflow, so slots are dropped."""
    jm, jp, m, p, cfg = pair
    x, router = _moe_inputs(cfg, b, s, seed=b * s, skew=skew)
    jparams = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    jparams = {**jparams, "router": jnp.asarray(router)}
    tparams = {k: t[0] for k, t in p["layers"]["moe"].items()}
    tparams["router"] = torch.from_numpy(router)
    want = np.asarray(JL.moe_block(jparams, jnp.asarray(x), jm.cfg))
    got = L.moe_block(tparams, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the drops: per row, choices beyond an expert's capacity
    e, k = cfg.moe_experts, cfg.moe_top_k
    cap = max(1, int(np.ceil(s * k * cfg.moe_capacity_factor / e)))
    _, ids = L._top_k(torch.softmax(torch.from_numpy(x) @ tparams["router"],
                                    dim=-1), k)
    counts = torch.stack([torch.bincount(r.reshape(-1), minlength=e)
                          for r in ids])
    dropped = int((counts - cap).clamp_min(0).sum())
    if skew and s > 1:
        assert dropped > 0
    if s == 1:
        assert dropped == 0                     # decode: cap 1, k distinct


def test_top_k_takes_the_lower_index_first_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = L._top_k(torch.from_numpy(probs), 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_expert_products_read_the_stacked_weights(pair, monkeypatch):
    """One batched product an expert matrix, over (E, B*C, in) and the
    stacked (E, in, out) weights as they are: never broadcast over B."""
    _, _, m, p, cfg = pair
    shapes = []
    real = torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, w: shapes.append(
        (tuple(a.shape), tuple(w.shape))) or real(a, w))
    lp = {k: t[0] for k, t in p["layers"]["moe"].items()}
    L.moe_block(lp, torch.ones((4, 1, cfg.d_model)), cfg)
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    assert shapes == [((e, 4, d), (e, d, f)), ((e, 4, d), (e, d, f)),
                      ((e, 4, f), (e, f, d))]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_shapes_are_repros_at_full_size(variant):
    """qwen3-moe-235b-a22b's full tree, shape for shape, against repro's
    abstract parameters (int8 experts and their scales in that variant):
    128 experts of d_ff 1536 in each of 94 layers, 235,093,610,496
    parameters in all."""
    over = VARIANTS[variant]
    jshapes = JModel(j_config(ARCH).with_overrides(**over)).abstract_params()
    cfg = get_config(ARCH).with_overrides(**over)
    shapes = param_shapes(cfg)
    special = L.moe_dtypes(cfg)

    def walk(j, t, path):
        if isinstance(t, dict):
            assert set(j) == set(t), path
            return sum(walk(j[k], t[k], f"{path}/{k}") for k in t)
        assert tuple(j.shape) == tuple(t), path
        name = path.rsplit("/", 1)[-1]
        if name in special:
            assert str(j.dtype) == str(special[name]).split(".")[-1], path
        return int(np.prod(t)) if not name.endswith("_scale") else 0
    assert walk(jshapes, shapes, "") == 235_093_610_496
    moe = shapes["layers"]["moe"]
    assert moe["w1"] == (94, 128, 4096, 1536) and "mlp" not in shapes["layers"]


def test_init_quantizes_like_repro():
    """int8 experts drawn on the device: int8 weights within +-127, each
    expert's largest reaching 127, f32 scales; the dequantized weights
    keep N(0, 1/d_model)."""
    cfg = get_smoke_config(ARCH).with_overrides(moe_weight_dtype="int8",
                                                d_model=256)
    params = Model(cfg).init(torch.Generator(device="cpu").manual_seed(3),
                             device="cpu")
    moe = params["layers"]["moe"]
    assert moe["w1"].dtype == torch.int8 and moe["w1_scale"].dtype \
        == torch.float32 and moe["w1_scale"].shape == (cfg.num_layers,
                                                       cfg.moe_experts)
    assert int(moe["w2"].abs().amax()) == 127
    assert torch.all(moe["w3"].abs().amax(dim=(2, 3)) == 127)
    w = moe["w1"].float() * moe["w1_scale"][..., None, None]
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert moe["router"].dtype == torch.bfloat16


def test_load_rejects_a_foreign_tree(pair):
    jm, jp, m, _, cfg = pair
    tree = jax.device_get(jp)
    tree["layers"]["moe"].pop("router")
    with pytest.raises(ValueError, match="moe"):
        m.load(tree, device="cpu")
    if cfg.moe_weight_dtype == "int8":
        tree = jax.device_get(jp)
        tree["layers"]["moe"]["w1"] = tree["layers"]["moe"]["w1"].astype(
            np.float32)
        with pytest.raises(ValueError, match="int8"):
            m.load(tree, device="cpu")

"""The port's VLM family against repro's on internvl2-2b smoke() (the dense
transformer, GQA 4 / 2, with 8 stub vision embeddings prepended to the
prompt) in float32, weights converted from repro's ``Model(cfg).init``:
an image prefill's logits and KV cache within 1e-4, 16 greedy per-slot
steps after it token-identical, one K5 call a layer over the image and the
prompt together, a prefill without ``image_embeds`` refused as repro
refuses it, chunked text admits and decode rounds on a Replica equal to
repro's Replica, and the full config's tree."""
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
ARCH = "internvl2-2b"


@pytest.fixture(scope="module")
def pair():
    over = dict(dtype="float32")
    jm = JModel(j_smoke(ARCH).with_overrides(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).with_overrides(**over)
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)) \
        .astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    return ({"tokens": jnp.asarray(tokens), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(tokens),
             "image_embeds": torch.from_numpy(img)})


def test_image_prefill_logits_and_cache_match(pair):
    jm, jp, m, p, cfg = pair
    jb, tb = _batch(cfg, 2, 6, seed=1)
    jl, jc = jax.jit(jm.prefill)(jp, jb, jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, tb, m.init_cache(2, MAX_LEN, device="cpu"))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)
    # the image's positions are filled, and nothing past the prompt
    filled = cfg.vision_tokens + 6
    assert tc["k"][:, :, filled - 1].abs().amax() > 0
    assert not tc["k"][:, :, filled:].any()


def test_sixteen_greedy_steps_after_an_image_prefill_match(pair):
    jm, jp, m, p, cfg = pair
    jb, tb = _batch(cfg, 2, 5, seed=2)
    jl, jc = jax.jit(jm.prefill)(jp, jb, jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, tb, m.init_cache(2, MAX_LEN, device="cpu"))
    jdec = jax.jit(jm.decode_step)
    jt = [np.asarray(jnp.argmax(jl, axis=-1))]
    tt = [torch.argmax(tl, dim=-1).numpy()]
    idx = np.full(2, cfg.vision_tokens + 5, np.int32)
    for _ in range(15):
        jl, jc = jdec(jp, jc, jnp.asarray(jt[-1][:, None], jnp.int32),
                      jnp.asarray(idx))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(tt[-1][:, None]),
                               torch.from_numpy(idx))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jt.append(np.asarray(jnp.argmax(jl, axis=-1)))
        tt.append(torch.argmax(tl, dim=-1).numpy())
        idx = idx + 1
    assert np.array_equal(np.stack(tt), np.stack(jt)) and len(tt) == 16


def test_an_image_prefill_runs_k5_once_a_layer(pair, monkeypatch):
    _, _, m, p, cfg = pair
    calls = []
    real = L._flash_op
    monkeypatch.setattr(L, "_flash_op", lambda q, k, v, causal: calls.append(
        (q.shape[1], k.shape[1], causal)) or real(q, k, v, causal=causal))
    _, tb = _batch(cfg, 2, 6, seed=3)
    m.prefill(p, tb, m.init_cache(2, MAX_LEN, device="cpu"))
    s = cfg.vision_tokens + 6
    assert calls == [(s, s, True)] * cfg.num_layers


def test_a_prefill_without_image_embeds_is_refused(pair):
    jm, jp, m, p, cfg = pair
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError):
        jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                   jm.init_cache(1, MAX_LEN))
    with pytest.raises(KeyError, match="image_embeds"):
        m.prefill(p, {"tokens": torch.from_numpy(tokens)},
                  m.init_cache(1, MAX_LEN, device="cpu"))


@pytest.mark.parametrize("fused", [True, False])
def test_chunked_text_admits_match_repros_replica(pair, fused):
    """Text-only prompts of 21, 5 and 16 tokens admitted in segments of 8
    (the VLM serves text through the dense path), then per-slot decode
    rounds in a bucket of 4 of 6 slots: repro's first tokens, streams,
    owners and KV cache."""
    jm, jp, m, p, cfg = pair
    assert m.supports_chunked_prefill and m.supports_per_slot_decode
    j = JReplica(jm, slots=6, max_len=MAX_LEN, prefill_chunk=8)
    j.attach_params(jp)
    t = Replica(m, slots=6, max_len=MAX_LEN, prefill_chunk=8, device="cpu")
    t.attach_params(p)
    assert t.prefill_chunk == 8
    jmem = JMembership(t_q=60.0, now=lambda: 0.0)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device="cpu")
    for i in range(3):
        jmem.request_join(f"10.9.0.{i}", 7000 + i)
        mem.request_join(f"10.9.0.{i}", 7000 + i)
    rng = np.random.default_rng(4)
    for i, n in enumerate((21, 5, 16)):
        pr = rng.integers(0, cfg.vocab, n, dtype=np.int32)
        assert t.admit(Request(f"v{i}", pr)) == j.admit(JRequest(f"v{i}", pr))
    for _ in range(4):
        jr = jmem.ring_state.device_bucket_table() if fused else None
        tr = mem.ring_state.device_bucket_table() if fused else None
        assert t.decode_round(route=tr) == j.decode_round(route=jr)
        assert t.routed_owners == j.routed_owners
    for name in ("k", "v"):
        np.testing.assert_allclose(t.cache[name].numpy(),
                                   np.asarray(j.cache[name]), atol=ATOL,
                                   rtol=0)


def test_param_shapes_are_repros_at_full_size():
    """internvl2-2b's full tree (the dense transformer's: 24 layers, d
    2048, 16 / 8 heads of 128, a 92,553-token vocabulary) against repro's
    abstract parameters; the parameter count ``configs.base`` gives."""
    jshapes = JModel(j_config(ARCH)).abstract_params()
    cfg = get_config(ARCH)
    shapes = param_shapes(cfg)

    def walk(j, t, path):
        if isinstance(t, dict):
            assert set(j) == set(t), path
            return sum(walk(j[k], t[k], f"{path}/{k}") for k in t)
        assert tuple(j.shape) == tuple(t), path
        return int(np.prod(t))
    assert walk(jshapes, shapes, "") == cfg.param_count()
    assert shapes["layers"]["attn"]["wk"] == (24, 2048, 8 * 128)

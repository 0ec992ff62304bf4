"""The port's encoder-decoder family against repro's on whisper-small
smoke() (2 + 2 layers, gelu, 16 stub audio frames) in float32, weights
converted from repro's ``Model(cfg).init``: the encoder alone, prefill
logits with the self K/V and the cross K/V filled from the frames within
1e-4, and 16 lockstep greedy steps token-identical.  The kernels of the
path: a prefill calls K5 once an encoder layer (no mask), once a decoder
layer for the self attention (causal) and once for the cross attention
(no mask, Sq = the prompt over Sk = T); a step calls K3 twice a decoder
layer (the cross attention at every row's length T).  The cross-attention
prefill on K5 against repro's unmasked einsum, in f32 and bf16.  Then the
family's flags and the full config's tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.models import encdec as E
from repro_torch.models import layers as L

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 32
ARCH = "whisper-small"


@pytest.fixture(scope="module")
def pair():
    over = dict(dtype="float32")
    jm = JModel(j_smoke(ARCH).with_overrides(**over))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH).with_overrides(**over)
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.audio_frames, cfg.d_model)) \
        .astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    return frames, tokens


def test_encoder_matches(pair):
    jm, jp, m, p, cfg = pair
    frames, _ = _inputs(cfg, 2, 1, seed=1)
    want = JE.encode(jp, jnp.asarray(frames), jm.cfg)
    got = E.encode(p, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_prefill_logits_and_cross_kv_match(pair):
    jm, jp, m, p, cfg = pair
    frames, tokens = _inputs(cfg, 2, 4, seed=2)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens),
                                      "frames": jnp.asarray(frames)},
                                 jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(tokens),
                           "frames": torch.from_numpy(frames)},
                       m.init_cache(2, MAX_LEN, device="cpu"))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv"}
    assert tc["xk"].shape == (cfg.num_layers, 2, cfg.audio_frames,
                              cfg.num_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for name in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


def test_sixteen_lockstep_greedy_steps_match(pair):
    jm, jp, m, p, cfg = pair
    frames, tokens = _inputs(cfg, 2, 4, seed=3)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens),
                                      "frames": jnp.asarray(frames)},
                                 jm.init_cache(2, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(tokens),
                           "frames": torch.from_numpy(frames)},
                       m.init_cache(2, MAX_LEN, device="cpu"))
    jdec = jax.jit(jm.decode_step)
    jt = [np.asarray(jnp.argmax(jl, axis=-1))]
    tt = [torch.argmax(tl, dim=-1).numpy()]
    for step in range(15):
        idx = tokens.shape[1] + step
        jl, jc = jdec(jp, jc, jnp.asarray(jt[-1][:, None], jnp.int32),
                      jnp.asarray(idx, jnp.int32))
        tl, tc = m.decode_step(p, tc, torch.from_numpy(tt[-1][:, None]), idx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jt.append(np.asarray(jnp.argmax(jl, axis=-1)))
        tt.append(torch.argmax(tl, dim=-1).numpy())
    assert np.array_equal(np.stack(tt), np.stack(jt)) and len(tt) == 16
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


def test_kernel_calls_of_a_prefill_and_a_step(pair, monkeypatch):
    """K5: one call an encoder layer (Sq = Sk = T, no mask), then in each
    decoder layer the self attention (causal, Sq = Sk = the prompt) and the
    cross attention (no mask, Sq = the prompt, Sk = T); a step: K3 for
    the self attention (length index + 1) and the cross attention (length
    T) in each decoder layer."""
    _, _, m, p, cfg = pair
    calls = []
    real_flash, real_decode = L._flash_op, L._decode_op
    monkeypatch.setattr(L, "_flash_op", lambda q, k, v, causal: calls.append(
        ("K5", q.shape[1], k.shape[1], causal)) or real_flash(
            q, k, v, causal=causal))
    monkeypatch.setattr(L, "_decode_op", lambda q, k, v, n: calls.append(
        ("K3", k.shape[1], n.tolist())) or real_decode(q, k, v, n))
    frames, tokens = _inputs(cfg, 2, 4, seed=4)
    t = cfg.audio_frames
    _, cache = m.prefill(p, {"tokens": torch.from_numpy(tokens),
                             "frames": torch.from_numpy(frames)},
                         m.init_cache(2, MAX_LEN, device="cpu"))
    assert calls == [("K5", t, t, False)] * cfg.encoder_layers \
        + [("K5", 4, 4, True), ("K5", 4, t, False)] * cfg.num_layers
    calls.clear()
    m.decode_step(p, cache, torch.zeros((2, 1), dtype=torch.int32), 4)
    assert calls == [("K3", MAX_LEN, [5, 5]), ("K3", t, [t, t])] \
        * cfg.num_layers


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_cross_attention_prefill_on_k5_matches_repros_einsum(pair, dtype,
                                                             tol):
    """A deliberate difference: the cross attention of a prefill (s > 1)
    runs on K5 without a mask, where repro runs the unmasked einsum of its
    jnp ``decode_attention`` and rounds p to v's dtype before p . v (K5
    keeps it in f32).  Equal in f32, within repro's bf16 flash tolerance in
    bf16."""
    jm, jp, m, p, cfg = pair
    rng = np.random.default_rng(5)
    h, hd, t = cfg.num_heads, cfg.resolved_head_dim, cfg.audio_frames
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((2, t, cfg.num_kv_heads, hd)).astype(np.float32)
    v = rng.standard_normal((2, t, cfg.num_kv_heads, hd)).astype(np.float32)
    xa = {n: w[0] for n, w in p["decoder"]["xattn"].items()}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jq = (jnp.asarray(x, jd) @ jnp.asarray(xa["wq"].numpy(), jd)).reshape(
        2, 6, h, hd)
    want = JL.decode_attention(jq, jnp.asarray(k, jd), jnp.asarray(v, jd))
    want = (want.reshape(2, 6, h * hd) @ jnp.asarray(xa["wo"].numpy(), jd))
    got = L.cross_attention({n: w.to(td) for n, w in xa.items()},
                            torch.from_numpy(x).to(td),
                            torch.from_numpy(k).to(td),
                            torch.from_numpy(v).to(td), cfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


def test_the_family_decodes_in_lockstep_and_admits_whole(pair):
    _, _, m, p, _ = pair
    assert not m.supports_per_slot_decode
    assert not m.supports_chunked_prefill
    with pytest.raises(NotImplementedError, match="chunked"):
        m.prefill_chunk(p, torch.zeros((1, 8), dtype=torch.int32),
                        m.init_cache(1, MAX_LEN, device="cpu"), 0)


def test_param_shapes_are_repros_at_full_size():
    """whisper-small's full tree, shape for shape, against repro's
    abstract parameters: 12 encoder and 12 decoder layers (self and cross
    attention) at d 768, gelu MLPs without w3: 277,893,120 parameters."""
    jshapes = JModel(j_config(ARCH)).abstract_params()
    cfg = get_config(ARCH)
    shapes = E.param_shapes(cfg)

    def walk(j, t, path):
        if isinstance(t, dict):
            assert set(j) == set(t), path
            return sum(walk(j[k], t[k], f"{path}/{k}") for k in t)
        assert tuple(j.shape) == tuple(t), path
        return int(np.prod(t))
    assert walk(jshapes, shapes, "") == 277_893_120
    assert shapes["decoder"]["xattn"]["wq"] == (12, 768, 768)
    assert "w3" not in shapes["encoder"]["mlp"]


def test_init_draws_repros_distributions():
    cfg = get_smoke_config(ARCH).with_overrides(d_model=256)
    params = Model(cfg).init(torch.Generator(device="cpu").manual_seed(3),
                             device="cpu")
    w = params["decoder"]["xattn"]["wk"].float()
    assert abs(w.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(params["embed"]["embedding"].float().std().item() - 0.02) \
        < 0.002
    assert torch.all(params["ln_enc"] == 1)
    assert params["encoder"]["ln1"].shape == (cfg.encoder_layers, 256)

"""The port's dense transformer against repro's on qwen2.5-3b smoke() in
float32, with weights converted from repro's ``Model(cfg).init``:
prefill logits within 1e-4, 16 greedy decode steps token-identical,
chunked prefill equal to a whole one, and per-slot decode at mixed
lengths equal to repro's.  Decode attention runs K3's plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import param_shapes

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

ATOL = 1e-4
MAX_LEN = 48


@pytest.fixture(scope="module")
def pair():
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
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
                      jnp.asarray([idx], jnp.int32))
        tl, tc = m.decode_step(p, tc, torch.tensor([[tt[-1]]]),
                               torch.tensor([idx], dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        jt.append(int(jnp.argmax(jl[0])))
        tt.append(int(torch.argmax(tl[0])))
    assert tt == jt and len(tt) == 16


def test_chunked_prefill_equals_whole(pair):
    _, _, m, p, cfg = pair
    prompt = _prompt(cfg, 21, 4)
    whole, wc = m.prefill(p, {"tokens": torch.from_numpy(prompt)[None]},
                          m.init_cache(1, MAX_LEN, device="cpu"))
    c = 8
    buf = np.zeros(24, np.int32)
    buf[:21] = prompt
    cache = m.init_cache(1, MAX_LEN, device="cpu")
    for off in range(0, 24, c):
        logits, cache = m.prefill_chunk(
            p, torch.from_numpy(buf[off:off + c])[None], cache, off)
    np.testing.assert_allclose(logits[0, 20 - 16].numpy(), whole[0].numpy(),
                               atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, :, :21].numpy(),
                                   wc[name][:, :, :21].numpy(), atol=ATOL)


def test_per_slot_decode_at_mixed_lengths_matches(pair):
    jm, jp, m, p, cfg = pair
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


def test_init_draws_repro_distributions_on_the_device():
    cfg = get_smoke_config("qwen2.5-3b")
    m = Model(cfg)
    gen = torch.Generator(device="cpu").manual_seed(3)
    params = m.init(gen, device="cpu")
    shapes = param_shapes(cfg)

    def walk(t, s):
        if isinstance(s, dict):
            assert set(t) == set(s)
            for k in s:
                walk(t[k], s[k])
        else:
            assert tuple(t.shape) == s and t.dtype == torch.bfloat16
    walk(params, shapes)
    assert torch.count_nonzero(params["layers"]["attn"]["bq"]) == 0
    assert torch.all(params["layers"]["ln1"] == 1)
    wq = params["layers"]["attn"]["wq"].float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    emb = params["embed"]["embedding"].float()
    assert abs(emb.std().item() / 0.02 - 1.0) < 0.05
    again = m.init(torch.Generator(device="cpu").manual_seed(3), device="cpu")
    assert torch.equal(again["layers"]["mlp"]["w2"],
                       params["layers"]["mlp"]["w2"])


def test_load_rejects_a_foreign_tree(pair):
    jm, jp, m, _, _ = pair
    tree = jax.device_get(jp)
    tree["layers"]["attn"].pop("bq")
    with pytest.raises(ValueError, match="attn"):
        m.load(tree, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**jax.device_get(jp), "ln_f": np.ones(3)}, m.cfg,
                        "cpu")


def test_other_families_are_not_ported():
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(family="moe",
                                                        moe_experts=4)
    with pytest.raises(NotImplementedError):
        Model(cfg)

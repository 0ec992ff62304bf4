"""The port's dense transformer against repro's on the smoke() config of
each dense architecture (qwen2.5-3b with QKV bias; internlm2-20b and
command-r-35b without; nemotron-4-15b with the two-matrix squared-ReLU
MLP) in float32, with weights converted from repro's ``Model(cfg).init``:
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


DENSE = ["qwen2.5-3b", "internlm2-20b", "nemotron-4-15b", "command-r-35b"]


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    jcfg = j_smoke(request.param).with_overrides(dtype="float32")
    cfg = get_smoke_config(request.param).with_overrides(dtype="float32")
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
    attn = tree["layers"]["attn"]
    attn.pop("bq" if "bq" in attn else "wq")
    with pytest.raises(ValueError, match="attn"):
        m.load(tree, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax({**jax.device_get(jp), "ln_f": np.ones(3)}, m.cfg,
                        "cpu")


@pytest.mark.parametrize("override", [
    dict(mla_kv_lora=32, mla_qk_nope_dim=16, mla_qk_rope_dim=8,
         mla_v_head_dim=16),                              # deepseek-v2's MLA
    dict(family="encdec", encoder_layers=2),              # whisper
    dict(family="vlm", vision_tokens=8)])                 # internvl2
def test_family_builds_its_module(override):
    """MLA, the encoder-decoder and the VLM build and dispatch to their
    module; of the three only the VLM takes chunked admits."""
    from repro_torch.models import encdec, model, transformer
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(**override)
    m = Model(cfg)
    assert model._module(cfg) is (encdec if cfg.family == "encdec"
                                  else transformer)
    assert m.supports_chunked_prefill == (cfg.family == "vlm")


def test_other_families_are_not_ported():
    """The expert-parallel MoE (``moe_impl="ep"``, the last variant that
    raised here) is ported: ``Model(cfg)`` builds, and without a mesh its
    blocks fall back to the GSPMD ``moe_block``, as repro's do, so its
    prefill and ``train_loss`` (and the loss's gradients) equal the
    GSPMD model's bit for bit."""
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(
        family="moe", moe_experts=4, moe_top_k=2, moe_d_ff=32, moe_impl="ep",
        dtype="float32")
    m, gspmd = Model(cfg), Model(cfg.with_overrides(moe_impl="gspmd"))
    assert m.supports_per_slot_decode
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.from_numpy(np.stack([_prompt(cfg, 12, 1),
                                        _prompt(cfg, 12, 2)]))
    out = [model.prefill(p, {"tokens": prompt},
                         model.init_cache(2, MAX_LEN, device="cpu"))
           for model in (m, gspmd)]
    assert torch.equal(out[0][0], out[1][0])
    for name in ("k", "v"):
        assert torch.equal(out[0][1][name], out[1][1][name])
    batch = {"tokens": prompt, "labels": prompt.roll(1, dims=1)}
    losses, grads = [], []
    for model in (m, gspmd):
        xs = {k: t.detach().clone().requires_grad_()
              for k, t in _leaf_paths(p)}
        loss = model.train_loss(_rebuild(p, xs), batch)
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, list(xs.values())))
    assert torch.equal(*losses)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _leaf_paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{pre}/{k}")
    else:
        yield pre, tree


def _rebuild(tree, leaves, pre=""):
    """``tree`` with the leaf at each path taken from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{pre}/{k}") for k, v in tree.items()}
    return leaves[pre]


@pytest.mark.parametrize("arch", DENSE)
def test_param_shapes_are_repros_at_full_size(arch):
    """The full configs' trees, shape for shape, against repro's abstract
    parameters (no weights are drawn): w3 only where the MLP is
    silu-gated, and the MLP's weights the count ``configs.base`` gives."""
    from repro.configs import get_config as j_config
    from repro_torch.configs import get_config
    jcfg_shapes = JModel(j_config(arch)).abstract_params()
    cfg = get_config(arch)
    shapes = param_shapes(cfg)

    def walk(j, t, path):
        if isinstance(t, dict):
            assert set(j) == set(t), path
            return sum(walk(j[k], t[k], f"{path}/{k}") for k in t)
        assert tuple(j.shape) == tuple(t), path
        return int(np.prod(t))
    walk(jcfg_shapes, shapes, "")
    mlp = shapes["layers"]["mlp"]
    assert ("w3" in mlp) == (cfg.act == "silu")
    assert sum(int(np.prod(t)) for t in mlp.values()) == cfg.num_layers \
        * (3 if cfg.act == "silu" else 2) * cfg.d_model * cfg.d_ff


def test_gelu_mlp_matches_repro():
    """repro's third activation, jax.nn.gelu (its tanh approximation by
    default), on internlm2-20b smoke(): prefill logits and three decode
    steps within 1e-4, two-matrix MLP."""
    over = dict(dtype="float32", act="gelu")
    jm = JModel(j_smoke("internlm2-20b").with_overrides(**over))
    jp = jm.init(jax.random.PRNGKey(1))
    m = Model(get_smoke_config("internlm2-20b").with_overrides(**over))
    p = m.load(jax.device_get(jp), device="cpu")
    assert set(p["layers"]["mlp"]) == {"w1", "w2"}
    prompt = _prompt(m.cfg, 11, 5)[None]
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)},
                                 jm.init_cache(1, MAX_LEN))
    tl, tc = m.prefill(p, {"tokens": torch.from_numpy(prompt)},
                       m.init_cache(1, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    tok = int(jnp.argmax(jl[0]))
    for step in range(3):
        idx = np.asarray([11 + step], np.int32)
        jl, jc = jax.jit(jm.decode_step)(jp, jc, jnp.asarray([[tok]]),
                                         jnp.asarray(idx))
        tl, tc = m.decode_step(p, tc, torch.tensor([[tok]]),
                               torch.from_numpy(idx))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        tok = int(jnp.argmax(jl[0]))
        assert tok == int(torch.argmax(tl[0]))


def test_relu2_tree_has_two_matrices():
    """nemotron-4-15b smoke(): repro's tree has no w3, ``params_from_jax``
    takes it as it is, and refuses the same tree with a w3 added."""
    cfg = get_smoke_config("nemotron-4-15b").with_overrides(dtype="float32")
    jm = JModel(j_smoke("nemotron-4-15b").with_overrides(dtype="float32"))
    tree = jax.device_get(jm.init(jax.random.PRNGKey(2)))
    assert set(tree["layers"]["mlp"]) == {"w1", "w2"}
    p = params_from_jax(tree, cfg, "cpu")
    assert p["layers"]["mlp"]["w1"].shape == (cfg.num_layers, cfg.d_model,
                                              cfg.d_ff)
    assert p["layers"]["mlp"]["w2"].shape == (cfg.num_layers, cfg.d_ff,
                                              cfg.d_model)
    tree["layers"]["mlp"]["w3"] = tree["layers"]["mlp"]["w1"]
    with pytest.raises(ValueError, match="mlp"):
        params_from_jax(tree, cfg, "cpu")
    drawn = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert set(drawn["layers"]["mlp"]) == {"w1", "w2"}


def test_mlp_refuses_an_activation_repro_does_not_know():
    from repro_torch.models import layers
    cfg = get_smoke_config("internlm2-20b").with_overrides(act="swish")
    x = torch.zeros(1, 2, cfg.d_model)
    w = {"w1": torch.zeros(cfg.d_model, cfg.d_ff),
         "w2": torch.zeros(cfg.d_ff, cfg.d_model)}
    with pytest.raises(NotImplementedError, match="swish"):
        layers.mlp(w, x, cfg)

"""The port's training path against repro's on the CPU, in float32, with
repro's weights converted and the same numpy batches fed to both:

* ``Model.train_loss`` and the gradient of every parameter leaf against
  ``jax.value_and_grad`` of repro's ``Model.train_loss``, for the
  ``smoke()`` configs of qwen2.5-3b (dense), qwen3-moe (MoE, gspmd),
  deepseek-v2 (MLA) and internvl2-2b (VLM, image prefix masked);
* one ``make_train_step`` step (params, m, v, step, grad_norm, lr, loss)
  against repro's, with microbatches 1 and 2 and with int8 compression;
* ``adamw.schedule`` at warm-up, mid-decay and the end; the remat modes
  giving one loss and one gradient (the SSM, hybrid and encoder-decoder
  families: ``test_torch_train_families.py``);
* ``SyntheticLM`` and ``dummy_batch`` batches equal to repro's.

Tolerances: loss 1e-5 absolute (a mean of O(5) f32 terms); each gradient
leaf within 1e-5 of its max |g| (the same f32 sums in another order);
after a step, parameters and moments within 1e-5 of repro's (an update
of lr ~ 3e-3 from the same gradients).  With int8 compression a gradient
within 1e-7 of a rounding boundary of the quantizer can land one level
apart in the two packages, so there at most 0.1% of a leaf's elements
may differ by more, and none by more than 2 lr; the quantizer itself
equals repro's on the same input exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.inputs import dummy_batch as j_dummy_batch
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.inputs import dummy_batch, input_specs
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, make_train_step

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
STEP_ATOL = 1e-5
ARCHS = ["qwen2.5-3b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
         "internvl2-2b"]


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{pre}/{k}"))
        return out
    return {pre: tree}


def _pair(arch):
    jcfg = j_smoke(arch).with_overrides(dtype="float32")
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = (rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _loss_and_grads(m, params, batch):
    flat = _flat(params)
    xs = {k: v.detach().requires_grad_() for k, v in flat.items()}

    def tree(t, pre=""):
        if isinstance(t, dict):
            return {k: tree(t[k], f"{pre}/{k}") for k in t}
        return xs[pre]
    loss = m.train_loss(tree(params), {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(xs.values()))
    return float(loss.detach()), dict(zip(xs, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_repro(arch):
    jm, jp, m, p, cfg = _pair(arch)
    batch = _batch(cfg, 2, 32, seed=1)
    jl, jg = jax.value_and_grad(jm.train_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _loss_and_grads(m, p, batch)
    assert abs(loss - float(jl)) <= LOSS_ATOL
    jg = _flat(jax.device_get(jg))
    assert set(grads) == set(jg)
    for name, g in grads.items():
        want = np.asarray(jg[name])
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g.numpy() - want).max()) <= GRAD_RTOL * scale, name


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_modes_give_the_same_loss_and_gradients(remat):
    _, _, m, p, cfg = _pair("qwen2.5-3b")
    batch = _batch(cfg, 2, 24, seed=2)
    loss, grads = _loss_and_grads(m, p, batch)
    m2 = Model(cfg.with_overrides(remat=remat))
    loss2, grads2 = _loss_and_grads(m2, p, batch)
    assert loss2 == loss
    for name in grads:
        assert torch.equal(grads2[name], grads[name]), name


@pytest.mark.parametrize("microbatches,compression", [(1, "none"), (2, "none"),
                                                      (1, "int8")])
def test_one_train_step_matches_repro(microbatches, compression):
    jm, jp, m, p, cfg = _pair("qwen2.5-3b")
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50)
    jopt = jadamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50)
    batch = _batch(cfg, 4, 32, seed=3)
    jstate = jadamw.init_state(jp, jopt)
    # a second step, so that the moments and the bias corrections are not
    # at their first-step values
    jstep = jax.jit(j_make_train_step(jm, JTrainConfig(
        opt=jopt, microbatches=microbatches, grad_compression=compression)))
    step = make_train_step(m, TrainConfig(opt=opt, microbatches=microbatches,
                                          grad_compression=compression))
    state = adamw.init_state(p, opt)
    for i in range(2):
        b = batch if i == 0 else _batch(cfg, 4, 32, seed=4)
        jp, jstate, jmet = jstep(jp, jstate, {k: jnp.asarray(v)
                                              for k, v in b.items()})
        p2, state2, met = step(p, state, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
        assert p2 is p and state2 is state          # updated in place
    for key in ("loss", "grad_norm", "lr"):
        assert met[key].dim() == 0
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, atol=0)
    assert int(state["step"]) == int(jstate["step"]) == 2
    assert state["step"].dtype == torch.int32
    for tree, jtree in ((p, jp), (state["m"], jstate["m"]),
                        (state["v"], jstate["v"])):
        jflat = _flat(jax.device_get(jtree))
        for name, t in _flat(tree).items():
            assert t.dtype == torch.float32
            diff = np.abs(t.numpy() - np.asarray(jflat[name]))
            if compression == "none":
                assert float(diff.max()) <= STEP_ATOL, name
            else:
                assert np.mean(diff > STEP_ATOL) <= 1e-3, name
                if tree is p:
                    assert float(diff.max()) <= 2 * opt.peak_lr, name


def test_int8_quantizer_equals_repros():
    from repro.train.step import _quantize_grads as j_quantize
    from repro_torch.train.step import _quantize_grads
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((64, 32)).astype(np.float32),
            "b": {"c": (rng.standard_normal(77) * 1e-3).astype(np.float32)}}
    got = _flat(_quantize_grads({"a": torch.from_numpy(tree["a"]),
                                 "b": {"c": torch.from_numpy(tree["b"]["c"])}}))
    want = _flat(jax.device_get(j_quantize(jax.tree.map(jnp.asarray, tree))))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name])


@pytest.mark.parametrize("step", [0, 3, 5, 27, 50, 80])
def test_schedule_matches_repro(step):
    """Warm-up (0, 3), its end (5), mid-decay (27), the end (50) and past
    it (80)."""
    cfg = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50)
    jcfg = jadamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50)
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                            ("bfloat16", "bfloat16")])
def test_adamw_in_pieces_is_bit_equal_to_the_whole_leaf_update(
        monkeypatch, dtype, moments):
    """Two steps with ``adamw._PIECE`` patched down to 7 values (every
    tensor of more than 7 cut along its leading axis, a row of more than 7
    values a piece) against the same steps on whole leaves: every
    parameter and moment equal bit for bit, each keeping its storage."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b").with_overrides(dtype=dtype)
    m = Model(cfg)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=1, total_steps=50,
                          moment_dtype=moments)
    runs, n_groups = [], []
    for piece in (adamw._PIECE, 7):
        monkeypatch.setattr(adamw, "_PIECE", piece)
        params = m.init(torch.Generator().manual_seed(0), device="cpu")
        state = adamw.init_state(params, opt)

        def tensors():
            return adamw.leaves(params) + adamw.leaves(state["m"]) \
                + adamw.leaves(state["v"])
        ptrs = [t.data_ptr() for t in tensors()]
        gen = torch.Generator().manual_seed(4)
        for _ in range(2):
            adamw.apply_updates(params, _random_like(params, gen), state, opt)
        assert [t.data_ptr() for t in tensors()] == ptrs
        runs.append(tensors())
        n_groups.append(len(adamw._groups(params)))
    assert n_groups[1] > 10 * n_groups[0]
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _random_like(tree, gen):
    if isinstance(tree, dict):
        return {k: _random_like(v, gen) for k, v in tree.items()}
    return torch.randn(tree.shape, generator=gen).to(tree.dtype)


def test_optimizer_state_matches_repros_tree():
    jm, jp, m, p, cfg = _pair("qwen2.5-3b")
    state = adamw.init_state(p, adamw.OptConfig())
    jstate = jadamw.init_state(jp, jadamw.OptConfig())
    assert set(state) == set(jstate) == {"m", "v", "step"}
    for key in ("m", "v"):
        jflat = _flat(jax.device_get(jstate[key]))
        flat = _flat(state[key])
        assert set(flat) == set(jflat)
        assert all(tuple(flat[n].shape) == jflat[n].shape for n in flat)
    np.testing.assert_allclose(
        float(adamw.global_norm(p)),
        float(jadamw.global_norm(jp)), rtol=1e-6)


def test_int8_experts_take_no_gradient():
    cfg = get_smoke_config("qwen3-moe-235b-a22b").with_overrides(
        moe_weight_dtype="int8", dtype="float32")
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(m, TrainConfig())
    with pytest.raises(ValueError, match="int8"):
        step(p, adamw.init_state(p, adamw.OptConfig()),
             {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 16, 0).items()})


def test_synthetic_lm_batches_equal_repros():
    for seed, step in ((0, 0), (3, 7)):
        cfg = dict(vocab=500, seq_len=48, global_batch=4, seed=seed)
        got = SyntheticLM(DataConfig(**cfg)).batch(step)
        want = JSyntheticLM(JDataConfig(**cfg)).batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internvl2-2b",
                                  "whisper-small"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_dummy_batch_equals_repros(arch, mode):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("t", 32, 2, mode)
    got = dummy_batch(cfg, shape, seed=5, device="cpu")
    want = j_dummy_batch(j_smoke(arch), JShape("t", 32, 2, mode), seed=5)
    assert list(got) == list(want) == list(input_specs(cfg, shape))
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))

"""Training of the SSM, hybrid and encoder-decoder families on the CPU, in
float32, against repro's, with repro's weights converted and the same
numpy batches fed to both:

* ``Model.train_loss`` and the gradient of every parameter leaf against
  ``jax.value_and_grad`` of repro's ``Model.train_loss``, for the
  ``smoke()`` configs of falcon-mamba-7b (Mamba-1: the scan on
  ``SsmScanFn``, K6b's plain version in the backward), zamba2-7b (Mamba-2
  SSD and the shared block) and whisper-small (the cross attention's K/V
  projected from the encoder output in each layer), at S = 32 on repro's
  chunk grid (ssm_chunk and loss_chunk 16);
* one ``make_train_step`` step (params, moments, step, grad_norm, lr,
  loss) against repro's for each of the three;
* the remat modes none, dots and full giving one loss and one gradient;
* K6b's plain version ``ssm_scan_bwd_ref`` (the reverse recurrence)
  against autograd through ``ssm_scan_ref``, with and without h0 and
  dh_last, in f32 and from bf16 inputs; ``SsmScanFn`` on CPU tensors;
* ``layers.attention(kv_x=...)`` against repro's, with QKV bias and rope
  at ``kv_positions``.

Tolerances, as ``test_torch_train.py``'s: loss 1e-5 absolute; each
gradient leaf within 1e-5 of its max |g|; after a step, parameters and
moments within 1e-5.  The plain backward against autograd: within 1e-5
of each gradient's max |g| (the same f32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.optim import adamw as jadamw
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, make_train_step

# one intra-op thread: the suite runs in several worker processes, and
# idle OpenMP threads spinning after each op would take their cores
torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
STEP_ATOL = 1e-5
ARCHS = ["falcon-mamba-7b", "zamba2-7b", "whisper-small"]
SEQ = 32                      # two ssm_chunk / loss_chunk of the smoke configs


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{pre}/{k}"))
        return out
    return {pre: tree}


def _pair(arch, **over):
    jcfg = j_smoke(arch).with_overrides(dtype="float32", **over)
    cfg = get_smoke_config(arch).with_overrides(dtype="float32", **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    return jm, jp, m, m.load(jax.device_get(jp), device="cpu"), cfg


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.audio_frames, cfg.d_model)).astype(np.float32)
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


def _close_to_scale(got, want, rtol, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - want).max()) <= rtol * scale, name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_repro(arch):
    jm, jp, m, p, cfg = _pair(arch)
    batch = _batch(cfg, 2, SEQ, seed=1)
    jl, jg = jax.value_and_grad(jm.train_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _loss_and_grads(m, p, batch)
    assert abs(loss - float(jl)) <= LOSS_ATOL
    jg = _flat(jax.device_get(jg))
    assert set(grads) == set(jg)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        _close_to_scale(g.numpy(), jg[name], GRAD_RTOL, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_repro(arch):
    jm, jp, m, p, cfg = _pair(arch)
    opt = adamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50)
    jopt = jadamw.OptConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50)
    batch = _batch(cfg, 2, SEQ, seed=3)
    jstep = jax.jit(j_make_train_step(jm, JTrainConfig(opt=jopt)))
    jstate = jadamw.init_state(jp, jopt)
    jp, jstate, jmet = jstep(jp, jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    step = make_train_step(m, TrainConfig(opt=opt))
    state = adamw.init_state(p, opt)
    p2, state2, met = step(p, state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    assert p2 is p and state2 is state          # updated in place
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, atol=0)
    assert int(state["step"]) == int(jstate["step"]) == 1
    for tree, jtree in ((p, jp), (state["m"], jstate["m"]),
                        (state["v"], jstate["v"])):
        jflat = _flat(jax.device_get(jtree))
        assert set(_flat(tree)) == set(jflat)
        for name, t in _flat(tree).items():
            diff = np.abs(t.numpy() - np.asarray(jflat[name]))
            assert float(diff.max()) <= STEP_ATOL, name


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_loss_and_gradients(arch, remat):
    _, _, m, p, cfg = _pair(arch)
    batch = _batch(cfg, 2, SEQ, seed=2)
    assert cfg.remat == "none"
    loss, grads = _loss_and_grads(m, p, batch)
    loss2, grads2 = _loss_and_grads(Model(cfg.with_overrides(remat=remat)),
                                    p, batch)
    assert loss2 == loss
    for name in grads:
        assert torch.equal(grads2[name], grads[name]), name


def test_remat_recomputes_the_scan_and_the_shared_block(monkeypatch):
    """Under remat the forward runs again in the backward: a Mamba-1
    layer's scan twice a pass (K6 forward and recompute) and once in
    K6b's place; the shared block at every site under any mode but
    ``none``, the Mamba layers only under theirs."""
    _, _, m, p, cfg = _pair("falcon-mamba-7b")
    batch = _batch(cfg, 2, SEQ, seed=2)
    calls = []
    real = ssm_ops.ssm_scan_bwd_ref

    def counted(*a):
        calls.append("bwd")
        return real(*a)
    monkeypatch.setattr(ssm_ops, "ssm_scan_bwd_ref", counted)
    fwd = []
    real_fwd = ssm_ops.ssm_scan_ref

    def counted_fwd(*a):
        fwd.append("fwd")
        return real_fwd(*a)
    monkeypatch.setattr(ssm_ops, "ssm_scan_ref", counted_fwd)
    _loss_and_grads(m, p, batch)
    assert (len(fwd), len(calls)) == (cfg.num_layers, cfg.num_layers)
    fwd.clear()
    calls.clear()
    _loss_and_grads(Model(cfg.with_overrides(remat="full")), p, batch)
    assert (len(fwd), len(calls)) == (2 * cfg.num_layers, cfg.num_layers)

    from repro_torch.models import hybrid
    _, _, mh, ph, hcfg = _pair("zamba2-7b")
    sites = []
    real_block = hybrid._shared_block

    def block(*a, **k):
        sites.append(1)
        return real_block(*a, **k)
    monkeypatch.setattr(hybrid, "_shared_block", block)
    for remat, per_site in (("none", 1), ("dots", 2), ("full", 2)):
        sites.clear()
        _loss_and_grads(Model(hcfg.with_overrides(remat=remat)), ph,
                        _batch(hcfg, 2, SEQ, seed=2))
        assert len(sites) == per_site * hybrid.num_shared_sites(hcfg), remat


def _scan_inputs(bb, l, din, n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    x, B, C = arr(bb, l, din, scale=0.5), arr(bb, l, n), arr(bb, l, n)
    dt = arr(bb, l, din, scale=0.3).abs()
    A = -arr(din, n).abs() - 0.1
    D = arr(din)
    h0, dh = arr(bb, din, n, scale=0.5), arr(bb, din, n)
    dy = arr(bb, l, din)
    return ([t.to(dtype) for t in (x, dt, B, C, A, D)], h0, dy.to(dtype), dh)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("bb,l,din,n", [(2, 37, 12, 8), (1, 64, 33, 16)])
def test_plain_backward_matches_autograd_of_the_plain_scan(with_h0, with_dh,
                                                           bb, l, din, n):
    (x, dt, B, C, A, D), h0, dy, dh = _scan_inputs(bb, l, din, n, seed=l)
    dt = dt.float()
    A = A.float()
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    leaves = [t.clone().requires_grad_() for t in (x, dt, B, C, A, D)] \
        + ([h0.clone().requires_grad_()] if with_h0 else [])
    y, h = ssm_scan_ref(*leaves[:6], leaves[6] if with_h0 else None)
    out = (y * dy).sum() + ((h * dh).sum() if with_dh else 0)
    want = torch.autograd.grad(out, leaves)
    got = ssm_scan_bwd_ref(x, dt, B, C, A, D, h0, dy, dh)
    assert (got[6] is None) == (not with_h0)
    for name, g, w, t in zip(("dx", "ddt", "dB", "dC", "dA", "dD", "dh0"),
                             got, want, leaves):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _close_to_scale(g.numpy(), w.numpy(), GRAD_RTOL, name)


def test_plain_backward_from_bf16_inputs():
    """The model's types: x, B, C, D, dy in bf16, dt, A, h0 in f32.  Every
    gradient in its input's dtype; dx, dB, dC and dD rounded once from
    the f32 sums (within 2^-7 of their max against autograd's f32
    gradients of the upcast inputs)."""
    (x, dt, B, C, A, D), h0, dy, dh = _scan_inputs(2, 48, 24, 16, seed=5,
                                                   dtype=torch.bfloat16)
    dt, A = dt.float(), A.float()
    got = ssm_scan_bwd_ref(x, dt, B, C, A, D, h0, dy, dh)
    leaves = [t.float().requires_grad_() for t in (x, dt, B, C, A, D, h0)]
    y, h = ssm_scan_ref(*leaves)
    want = torch.autograd.grad((y * dy.float()).sum() + (h * dh).sum(),
                               leaves)
    for name, g, w, t, tol in zip(
            ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0"), got, want,
            (x, dt, B, C, A, D, h0),
            (2 ** -7, GRAD_RTOL, 2 ** -7, 2 ** -7, GRAD_RTOL, 2 ** -7,
             GRAD_RTOL)):
        assert g.dtype == t.dtype, name
        _close_to_scale(g.float().numpy(), w.numpy(), tol, name)


@pytest.mark.parametrize("with_h0", [True, False])
def test_ssm_scan_fn_on_cpu_tensors(with_h0):
    """``ssm_scan`` under autograd runs ``SsmScanFn``: its forward is the
    plain scan, its backward the plain backward bit for bit (within 1e-5
    of autograd through the plain scan), and no kernel launches."""
    (x, dt, B, C, A, D), h0, dy, dh = _scan_inputs(2, 40, 16, 8, seed=9)
    h0 = h0 if with_h0 else None
    leaves = [t.clone().requires_grad_() for t in (x, dt, B, C, A, D)] \
        + ([h0.clone().requires_grad_()] if with_h0 else [])
    fn = ssm_ops.ssm_scan
    before = (fn.launches, fn.bwd_launches)
    y, h = fn(*leaves[:6], leaves[6] if with_h0 else None)
    assert type(y.grad_fn).__name__ == "SsmScanFnBackward"
    wy, wh = ssm_scan_ref(x, dt, B, C, A, D, h0)
    assert torch.equal(y.detach(), wy) and torch.equal(h.detach(), wh)
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    assert (fn.launches, fn.bwd_launches) == before
    plain = ssm_scan_bwd_ref(x, dt, B, C, A, D, h0, dy, dh)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    ref_leaves = [t.clone().requires_grad_() for t in leaves]
    ry, rh = ssm_scan_ref(*ref_leaves[:6],
                          ref_leaves[6] if with_h0 else None)
    want = torch.autograd.grad((ry * dy).sum() + (rh * dh).sum(), ref_leaves)
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), w.numpy(), GRAD_RTOL, "SsmScanFn")
    # only y used: dh_last reaches the backward as None, read as zeros
    leaves = [t.clone().requires_grad_() for t in (x, dt, B, C, A, D)]
    y, _ = fn(*leaves)
    got = torch.autograd.grad((y * dy).sum(), leaves)
    plain = ssm_scan_bwd_ref(x, dt, B, C, A, D, None, dy, None)
    assert all(torch.equal(g, w) for g, w in zip(got, plain[:6]))
    with torch.no_grad():
        y2, _ = fn(x, dt, B, C, A, D)
    assert y2.grad_fn is None


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_over_kv_x_matches_repro(rope, causal):
    """Queries from x (B, 12, d), keys and values from kv_x (B, 20, d) (and
    12 for the causal case, which needs Sq == Sk), with QKV bias, without
    rope (whisper's cross attention) or with rope at the keys' own
    ``kv_positions``: repro's ``layers.attention`` with ``kv_x``."""
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    assert cfg.qkv_bias
    jp = JL.attention_params(jcfg, jax.random.PRNGKey(3))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    sk = 12 if causal else 20
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, sk, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    kpos = np.broadcast_to(np.arange(sk) + 5, (2, sk)) if rope else None
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                           causal=causal, kv_x=jnp.asarray(kv),
                           use_rope=rope,
                           kv_positions=None if kpos is None
                           else jnp.asarray(kpos))
    got, cache = L.attention(p, torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(pos.copy()),
                             causal=causal, kv_x=torch.from_numpy(kv),
                             use_rope=rope,
                             kv_positions=None if kpos is None
                             else torch.from_numpy(kpos.copy()))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)

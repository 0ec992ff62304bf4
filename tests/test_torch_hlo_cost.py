"""The port's cost counter (``repro_torch.launch.hlo_cost``) against
``repro``'s HLO walker (``repro.launch.hlo_cost.analyze``) on the four
programs of ``tests/test_hlo_cost.py``, against closed forms, and the
kernels' charges and meta routes (``kernels/*/ops.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.hlo_cost import analyze
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.launch.hlo_cost import COLLECTIVES, CostCounter, fn_cost
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import specs as sh

torch.set_num_threads(1)
META = torch.device("meta")
DEVICES = ["cpu", "meta"]


def _jax_matmul_flops(f, *specs) -> float:
    return analyze(jax.jit(f).lower(*specs).compile().as_text())[
        "matmul_flops"]


def _tensor(shape, device, dtype=torch.float32, grad=False):
    t = torch.empty(shape, dtype=dtype, device=device) if device == "meta" \
        else torch.randn(shape, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32).to(dtype)
    return t.requires_grad_(grad)


# -- the four programs of tests/test_hlo_cost.py, as torch loops -------------

@pytest.mark.parametrize("device", DEVICES)
def test_scan_flops_loop_scaled(device):
    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    def jf(x, ws):
        out, _ = jax.lax.scan(lambda c, w: (c @ w, None), x, ws)
        return out
    r = fn_cost(f, _tensor((64, 64), device), _tensor((10, 64, 64), device))
    assert r["matmul_flops"] == 10 * 2 * 64**3 == _jax_matmul_flops(
        jf, jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((10, 64, 64), jnp.float32))


@pytest.mark.parametrize("device", DEVICES)
def test_nested_scan_flops(device):
    def g(x, ws):
        for _ in range(5):
            for w in ws:
                x = x @ w
        return x

    def jg(x, ws):
        def outer(c, _):
            out, _ = jax.lax.scan(lambda cc, w: (cc @ w, None), c, ws)
            return out, None
        out, _ = jax.lax.scan(outer, x, None, length=5)
        return out
    r = fn_cost(g, _tensor((64, 64), device), _tensor((10, 64, 64), device))
    assert r["matmul_flops"] == 50 * 2 * 64**3 == _jax_matmul_flops(
        jg, jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((10, 64, 64), jnp.float32))


@pytest.mark.parametrize("device", DEVICES)
def test_plain_matmul_flops(device):
    r = fn_cost(lambda a, b: a @ b, _tensor((128, 256), device),
                _tensor((256, 64), device))
    assert r["matmul_flops"] == 2 * 128 * 256 * 64 == _jax_matmul_flops(
        lambda a, b: a @ b, jax.ShapeDtypeStruct((128, 256), jnp.float32),
        jax.ShapeDtypeStruct((256, 64), jnp.float32))
    # boundary bytes at least operands + result
    assert r["hbm_bytes"] >= (128 * 256 + 256 * 64 + 128 * 64) * 4
    assert r["arithmetic_intensity"] == r["matmul_flops"] / r["hbm_bytes"]


@pytest.mark.parametrize("device", DEVICES)
def test_bytes_scale_with_trip_count(device):
    def f7(x):
        for _ in range(7):
            x = torch.tanh(x) * 2.0
        return x

    def f1(x):
        return torch.tanh(x) * 2.0
    x = _tensor((256, 256), device)
    r7, r1 = fn_cost(f7, x), fn_cost(f1, x)
    assert r7["hbm_bytes"] >= 5 * max(r1["hbm_bytes"], 1)
    assert r1["hbm_bytes"] == 4 * 256 * 256 * 4      # tanh and mul: in, out


# -- what the counter counts ---------------------------------------------------

def test_a_program_counts_the_same_on_the_cpu_and_on_meta():
    """A plain-torch MLP's forward and backward, no kernel in it: the same
    FLOPs, bytes and temporaries on both devices."""
    def step(w1, w2, x):
        loss = (torch.relu(x @ w1) @ w2).square().mean()
        return torch.autograd.grad(loss, (w1, w2))
    got = {}
    for device in DEVICES:
        args = (_tensor((32, 64), device, grad=True),
                _tensor((64, 16), device, grad=True),
                _tensor((8, 32), device))
        got[device] = fn_cost(step, *args)
    assert got["cpu"] == got["meta"]
    assert got["cpu"]["matmul_flops"] == 3 * 2 * 8 * (32 * 64 + 64 * 16) \
        - 2 * 8 * 32 * 64                      # no gradient of x


def test_temporaries_are_the_peak_of_live_non_argument_bytes():
    n = 1 << 18
    x = torch.empty(n, device=META)

    def f(x):
        a = x * 2            # 1 MiB live
        b = a * 3            # 2 MiB live
        del a
        return b + 1         # 2 MiB live: a is gone
    assert fn_cost(f, x)["temp_bytes"] == 2 * 4 * n
    y = x.clone()
    assert fn_cost(lambda t: t.mul_(2), y)["temp_bytes"] == 0   # in place


def test_views_and_allocations_move_no_bytes():
    x = torch.empty((64, 64), device=META)
    r = fn_cost(lambda t: (t.t(), t.view(-1), t[1:], torch.empty_like(t)), x)
    assert r["hbm_bytes"] == 0 and r["matmul_flops"] == 0
    assert fn_cost(lambda t: torch.zeros_like(t), x)["hbm_bytes"] == 64 * 64 * 4
    y = torch.empty((64, 64), device=META)
    assert fn_cost(lambda a, b: a.copy_(b), x, y)["hbm_bytes"] == 2 * 64 * 64 * 4


# -- the kernels' charges ----------------------------------------------------

def _charge(fn, *args):
    """The kernel charges of ``fn(*args)`` on meta tensors."""
    with CostCounter(args) as counter:
        fn(*args)
    return counter.kernels


def _meta(*shapes, dtype=torch.bfloat16, grad=False):
    return [torch.empty(s, dtype=dtype, device=META, requires_grad=grad)
            for s in shapes]


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,dv", [
    (1, 64, 64, 4, 2, 32, 32), (2, 7, 30, 4, 4, 16, 16),
    (1, 33, 17, 8, 2, 24, 16)])
def test_non_causal_k5_charge_is_the_flop_counters_count_of_the_plain(
        b, sq, sk, h, hkv, hd, dv):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, dv)))
    with FlopCounterMode(display=False) as fc:
        flash_attention_ref(q, k, v, causal=False)
    got = _charge(lambda *t: fa_ops.flash_attention(*t, causal=False),
                  *(t.to(META) for t in (q, k, v)))
    assert got["K5"]["matmul_flops"] == fc.get_total_flops()
    assert got["K5"]["calls"] == 1


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,dv,dtype", [
    (1, 1024, 1024, 16, 2, 128, 128, torch.bfloat16),
    (1, 1000, 1000, 16, 2, 128, 128, torch.float16),
    (8, 4, 1500, 12, 12, 64, 64, torch.bfloat16),
    (2, 300, 77, 4, 2, 192, 128, torch.float32),
    (1, 5, 9, 2, 1, 16, 16, torch.bfloat16)])
def test_causal_k5_and_k5b_charges_are_the_closed_form(b, sq, sk, h, hkv, hd,
                                                       dv, dtype):
    """K5 top-left causal: query i sees min(i + 1, Sk) keys; K5b (Sq = Sk
    for a causal backward): Sq (Sq + 1) / 2 pairs."""
    size = torch.empty((), dtype=dtype).element_size()
    pairs = sum(min(i + 1, sk) for i in range(sq))
    got = _charge(lambda *t: fa_ops.flash_attention(*t, causal=True),
                  *_meta((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, dv),
                         dtype=dtype))["K5"]
    assert got["matmul_flops"] == 2 * b * h * (hd + dv) * pairs
    assert got["bytes"] == size * (b * sq * h * hd + b * sk * hkv * (hd + dv)
                                   + b * sq * h * dv)
    q, k, v = _meta((b, sq, h, hd), (b, sq, hkv, hd), (b, sq, hkv, dv),
                    dtype=dtype, grad=True)

    def train(q, k, v):
        o = fa_ops.FlashAttentionFn.apply(q, k, v, True)
        torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    got = _charge(train, q, k, v)
    assert got["K5"]["bytes"] == size * (b * sq * h * hd + b * sq * hkv
                                         * (hd + dv) + b * sq * h * dv) \
        + 4 * b * h * sq                                  # with the lse
    pairs = sq * (sq + 1) // 2
    assert got["K5b"]["matmul_flops"] == 2 * b * h * pairs * (3 * hd + 2 * dv)
    assert got["K5b"]["bytes"] == size * 2 * (
        b * sq * h * hd + b * sq * hkv * (hd + dv) + b * sq * h * dv) \
        + 4 * b * h * sq


@pytest.mark.parametrize("b,s,h,hkv,hd,dtype", [
    (16, 2048, 16, 2, 128, torch.bfloat16), (8, 1500, 12, 12, 64,
                                              torch.bfloat16),
    (3, 100, 4, 1, 64, torch.float32)])
def test_k3_charge_is_the_closed_form_at_the_caches_capacity(b, s, h, hkv, hd,
                                                             dtype):
    size = torch.empty((), dtype=dtype).element_size()
    q, k, v = _meta((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), dtype=dtype)
    got = _charge(da_ops.decode_attention, q, k, v,
                  torch.empty((b,), dtype=torch.int32, device=META))["K3"]
    assert got["bytes"] == 2 * b * s * hkv * hd * size + 2 * b * h * hd * size \
        + 4 * b
    assert got["matmul_flops"] == 4 * b * s * h * hd and got["ops"] == 0
    # a bound that has the lengths passes the positions they cover
    w = da_ops.decode_attention_work(q, k, v, None, positions=7)
    assert w["matmul_flops"] == 4 * 7 * h * hd


@pytest.mark.parametrize("bb,l,din,n,h0", [(1, 1024, 8192, 16, False),
                                           (2, 37, 24, 4, True)])
def test_k6_and_k6b_charges_are_the_closed_form(bb, l, din, n, h0):
    """K6: 7 f32 operations a (position, channel, state) and 3 a (position,
    channel), no matmul FLOPs; K6b: 16 and 3; bytes each input once and
    each output once."""
    x, B, C, D = _meta((bb, l, din), (bb, l, n), (bb, l, n), (din,),
                       grad=True)
    dt, A = _meta((bb, l, din), (din, n), dtype=torch.float32, grad=True)
    h = _meta((bb, din, n), dtype=torch.float32, grad=True)[0] if h0 else None
    ins = [x, dt, B, C, A, D] + ([h] if h0 else [])
    in_bytes = sum(t.numel() * t.element_size() for t in ins)

    def train(*ts):
        y, h_last = ssm_ops.SsmScanFn.apply(*ts, *([] if h0 else [None]))
        outs, grads = [y], [torch.empty_like(y)]
        if h0:
            outs.append(h_last)
            grads.append(torch.empty_like(h_last))
        torch.autograd.grad(outs, ts, grads)
    got = _charge(train, *ins)
    cells = bb * l * din
    assert got["K6"] == {"calls": 1, "matmul_flops": 0,
                         "ops": cells * (7 * n + 3),
                         "exponentials": cells * n,
                         "bytes": in_bytes + x.numel() * 2 + bb * din * n * 4}
    dy = x.numel() * 2 + (bb * din * n * 4 if h0 else 0)
    assert got["K6b"] == {"calls": 1, "matmul_flops": 0,
                          "ops": cells * (16 * n + 3),
                          "exponentials": cells * n,
                          "bytes": 2 * in_bytes + dy}


def _refuse(*a, **kw):
    raise AssertionError("a meta tensor reached a launcher or a plain version")


def test_meta_calls_reach_no_launcher_and_no_plain_version(monkeypatch):
    for mod, names in ((da_ops, ("decode_attention_cuda",
                                 "decode_attention_ref")),
                       (fa_ops, ("flash_attention_cuda", "flash_attention_ref",
                                 "flash_attention_fwd_ref",
                                 "flash_attention_bwd_cuda",
                                 "flash_attention_bwd_ref")),
                       (ssm_ops, ("ssm_scan_cuda", "ssm_scan_ref",
                                  "ssm_scan_bwd_cuda", "ssm_scan_bwd_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    before = (da_ops.decode_attention.launches, fa_ops.flash_attention.launches,
              fa_ops.flash_attention.bwd_launches, ssm_ops.ssm_scan.launches,
              ssm_ops.ssm_scan.bwd_launches)
    q, k = _meta((2, 4, 16), (2, 9, 2, 16))
    out = da_ops.decode_attention(q, k, k, torch.empty(2, dtype=torch.int32,
                                                       device=META))
    assert (out.shape, out.dtype, out.device) == ((2, 4, 16), q.dtype, META)
    q, k, v = _meta((2, 5, 4, 24), (2, 7, 2, 24), (2, 7, 2, 16), grad=True)
    o = fa_ops.flash_attention(q, k, v, causal=True)
    assert (o.shape, o.dtype) == ((2, 5, 4, 16), q.dtype)
    o = fa_ops.FlashAttentionFn.apply(q, k, v, True)
    grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    x, B = _meta((2, 6, 8), (2, 6, 4), grad=True)
    dt, A = _meta((2, 6, 8), (8, 4), dtype=torch.float32, grad=True)
    D, = _meta((8,), grad=True)
    y, h_last = ssm_ops.ssm_scan(x, dt, B, B, A, D)
    assert (y.shape, y.dtype, h_last.shape, h_last.dtype) == (
        x.shape, x.dtype, (2, 8, 4), torch.float32)
    grads = torch.autograd.grad(y, (x, dt, B, A, D), torch.empty_like(y))
    assert [g.dtype for g in grads] == [t.dtype for t in (x, dt, B, A, D)]
    assert before == (da_ops.decode_attention.launches,
                      fa_ops.flash_attention.launches,
                      fa_ops.flash_attention.bwd_launches,
                      ssm_ops.ssm_scan.launches,
                      ssm_ops.ssm_scan.bwd_launches)


def test_cpu_tensors_take_the_plain_version_and_charge_no_kernel():
    q, k = torch.randn(2, 4, 16), torch.randn(2, 9, 2, 16)
    with CostCounter() as counter:
        da_ops.decode_attention(q, k, k, torch.tensor([3, 9],
                                                      dtype=torch.int32))
    r = counter.result()
    assert r["kernels"] == {} and r["aten"]["matmul_flops"] > 0


# -- collectives ---------------------------------------------------------------

def test_the_ports_collectives_charge_repros_names():
    n, x = 4, [torch.randn(6, 5) for _ in range(4)]
    with CostCounter() as c:
        coll.edra_allgather(x)
    # 2 rounds: each peer sends 1 block, then 2
    assert c.result()["collective_bytes_by_op"] == {
        "collective-permute": n * 3 * 6 * 5 * 4}
    assert c.result()["hbm_bytes"] == 0       # the sends are the collective's
    with CostCounter() as c:
        coll.edra_broadcast(x, source=2)
    assert c.collective_bytes_by_op == {"collective-permute": 3 * 6 * 5 * 4}
    with CostCounter() as c:
        coll.edra_allreduce(x)
    padded = 32 * 4                            # 30 values padded to 4 x 8
    assert c.collective_bytes_by_op == {
        "reduce-scatter": padded, "collective-permute": n * 3 * padded // n}
    with CostCounter() as c, sh.tp_context("model", 0, lambda i, t: t * 2):
        sh.psum_tp(torch.ones(3, 4))
    assert c.result()["collective_bytes"] == 48
    assert set(c.collective_bytes_by_op) <= set(COLLECTIVES)


def test_the_expert_parallel_exchange_charges_all_to_all():
    from repro_torch.models import Model
    from repro_torch.models.moe_ep import capacities, moe_block_ep
    cfg = get_smoke_config("qwen3-moe-235b-a22b").with_overrides(
        dtype="float32", moe_impl="ep")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    layer = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn(2, 8, cfg.d_model)
    with sh.mesh_context(make_host_mesh(2, ["cpu"] * 4)), \
            CostCounter() as c:
        out = moe_block_ep(layer, x, cfg)
    assert out is not None and out.shape == x.shape
    # each of the 2 x 2 shards sends and gets back M c2 rows of d_model
    # f32 values, and sends M c2 expert ids
    c2, _ = capacities(8 // 2, cfg, 2)
    rows = 4 * 2 * c2
    assert c.collective_bytes_by_op == {
        "all-to-all": 2 * rows * cfg.d_model * 4 + rows * 8}


def test_fn_cost_keeps_repros_keys():
    r = fn_cost(lambda a: a @ a, torch.empty((8, 8), device=META))
    for key in ("matmul_flops", "hbm_bytes", "collective_bytes_by_op",
                "collective_bytes", "arithmetic_intensity"):
        assert key in r
    assert math.isclose(r["arithmetic_intensity"],
                        2 * 8**3 / (3 * 8 * 8 * 4))
    assert np.isfinite(r["temp_bytes"])

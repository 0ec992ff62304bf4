"""The frozen work counts (``harness/work.py``) equal what the port's cost
counter (``launch/hlo_cost.py``) charges today at smoke sizes: K5's work
against ``flash_attention_work``, and a forward's model FLOPs against the
counter's matmul FLOPs where the port computes no padding (as many
experts as experts a token and a capacity factor of 1, so that every
expert slot holds a token; a decode step over a cache exactly as long as
the context).  MLA's decode is absorbed in the port (other products over
the latent cache), so only its prefill is held to the closed form."""
import pytest
import torch

from harness import work
from harness.spec import port_config_kwargs
from test_port_bench_reference import smoke_config

UNPADDED = dict(n_routed_experts=2, num_experts=2, num_experts_per_tok=2)


def _model(name):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    cfg = smoke_config(name, **UNPADDED)
    if name == "qwen3-moe-l8":
        cfg.pop("n_routed_experts")
    else:
        cfg.pop("num_experts")
    kw = port_config_kwargs(cfg)
    kw.update(moe_capacity_factor=1.0, dtype="bfloat16")
    return cfg, Model(ModelConfig(**kw))


def _counted(fn, *args):
    from repro_torch.launch.hlo_cost import fn_cost
    return fn_cost(fn, *args)


@pytest.mark.parametrize("name", ["dsv2-l6", "qwen3-moe-l8"])
@pytest.mark.parametrize("s", [5, 24])
def test_prefill_flops_and_k5_charge(name, s):
    cfg, model = _model(name)
    params = model.abstract_params()
    cache = model.cache_shapes(1, 32)
    tok = torch.empty((1, s), dtype=torch.int32, device="meta")
    cost = _counted(model.prefill, params, {"tokens": tok}, cache)
    assert cost["matmul_flops"] == work.prefill_flops(cfg, s)
    k5 = cost["kernels"]["K5"]
    layers = cfg["num_hidden_layers"]
    assert k5["calls"] == layers
    assert k5["bytes"] == layers * work.k5_work(cfg, s)["bytes"]
    assert k5["matmul_flops"] == layers * work.k5_work(cfg, s)["matmul_flops"]


@pytest.mark.parametrize("context", [1, 17])
def test_gqa_decode_flops(context):
    cfg, model = _model("qwen3-moe-l8")
    params = model.abstract_params()
    cache = model.cache_shapes(1, context)
    tok = torch.empty((1, 1), dtype=torch.int32, device="meta")
    cost = _counted(model.decode_step, params, cache, tok, context - 1)
    assert cost["matmul_flops"] == work.decode_flops(cfg, context)


def test_k5_work_is_flash_attention_work():
    from repro_torch.kernels.flash_attention.ops import flash_attention_work
    for name, (h, hk, dk, dv) in {"dsv2-l6": (4, 4, 24, 16),
                                  "qwen3-moe-l8": (8, 2, 16, 16)}.items():
        cfg = smoke_config(name)
        for s in (1, 9, 300):
            q = torch.empty((1, s, h, dk), dtype=torch.bfloat16, device="meta")
            k = torch.empty((1, s, hk, dk), dtype=torch.bfloat16, device="meta")
            v = torch.empty((1, s, hk, dv), dtype=torch.bfloat16, device="meta")
            want = flash_attention_work(q, k, v, causal=True)
            got = work.k5_work(cfg, s)
            assert got["bytes"] == want["bytes"]
            assert got["matmul_flops"] == want["matmul_flops"]


def test_bound_is_the_larger_of_flops_and_bytes():
    cfg = smoke_config("dsv2-l6")
    w = work.k5_work(cfg, 100)
    assert work.k5_bound_s(cfg, 100) == max(
        w["matmul_flops"] / work.PEAK_BF16_FLOPS,
        w["bytes"] / work.PEAK_HBM_BYTES)

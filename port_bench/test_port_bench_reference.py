"""The plain reference against the port's CPU path at smoke sizes (the same
seeded float32 tensors: a whole-prompt prefill whose experts drop past
their capacity, then tokens decoded through the cache), and the import
guard: nothing under ``port_bench/`` imports jax, flax or ``repro`` or
reads ``benchmarks/``, and the reference imports nothing of the port."""
import ast
import math

import pytest
import torch

from harness.reference import Reference
from harness.spec import BENCH_DIR, port_config_kwargs, read_json
from harness.weights import make_weights

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SMOKE = {
    "dsv2-l6": dict(hidden_size=64, num_attention_heads=4,
                    num_key_value_heads=4, kv_lora_rank=32, q_lora_rank=48,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    n_routed_experts=8, num_experts_per_tok=2,
                    moe_intermediate_size=96, n_shared_experts=1,
                    vocab_size=256, num_hidden_layers=2),
    "qwen3-moe-l8": dict(hidden_size=64, num_attention_heads=8,
                         num_key_value_heads=2, head_dim=16, num_experts=8,
                         num_experts_per_tok=2, moe_intermediate_size=96,
                         vocab_size=256, num_hidden_layers=2),
}


def smoke_config(name, **over):
    cfg = read_json(BENCH_DIR / "configs" / f"{name}.json")
    cfg.update(SMOKE[name], **over)
    return cfg


def port_model(cfg, dtype="float32"):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    kw = port_config_kwargs(cfg)
    kw["dtype"] = dtype
    return Model(ModelConfig(**kw))


@pytest.mark.parametrize("name", sorted(SMOKE))
@pytest.mark.parametrize("prompt", [7, 40])
def test_reference_matches_the_ports_cpu_path(name, prompt):
    cfg = smoke_config(name)
    model = port_model(cfg)
    weights = make_weights(model.abstract_params(), 5, torch.device("cpu"))
    toks = torch.randint(0, cfg["vocab_size"], (prompt + 6,),
                         generator=torch.Generator().manual_seed(prompt))
    cache = model.init_cache(1, 64, device="cpu")
    logits, cache = model.prefill(weights, {"tokens": toks[None, :prompt]},
                                  cache)
    port = [logits[0]]
    for j in range(5):
        logits, cache = model.decode_step(
            weights, cache, toks[None, prompt + j:prompt + j + 1], prompt + j)
        port.append(logits[0])
    ref = Reference(cfg, weights).logits(
        toks[:prompt + 5], prompt, list(range(prompt - 1, prompt + 5)))
    got = torch.stack(port)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_reference_drops_past_capacity_as_the_port():
    """A prompt long enough that experts overflow: the kept mask drops
    exactly the (token, choice) slots past ceil(P k 1.25 / E) in token
    order, and the logits still agree."""
    cfg = smoke_config("qwen3-moe-l8")
    ref = Reference(cfg, {})
    ids = torch.tensor([[0, 1]] * 6 + [[2, 3]] * 2)          # P 8, k 2, E 8
    keep = ref.kept(ids, 8)
    cap = math.ceil(8 * 2 * 1.25 / 8)                         # 3
    assert keep[:, 0].tolist() == [True] * cap + [False] * 3 + [True] * 2
    assert keep.sum() == 2 * cap + 4
    assert ref.kept(ids, 0).all()                              # decoded tokens


def test_fp8_control_departs_from_the_reference():
    cfg = smoke_config("dsv2-l6", hidden_size=128, moe_intermediate_size=192)
    model = port_model(cfg)
    weights = make_weights(model.abstract_params(), 9, torch.device("cpu"))
    toks = torch.randint(0, 256, (48,), generator=torch.Generator().manual_seed(3))
    pos = list(range(20, 48))
    f32 = Reference(cfg, weights).logits(toks, 21, pos)
    fp8 = Reference(cfg, weights, "fp8").logits(toks, 21, pos)
    gap = f32.max(-1).values - f32.gather(1, fp8.argmax(-1)[:, None])[:, 0]
    assert float(gap.mean()) > 0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_no_repro_no_benchmarks_dir():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = set(_imports(f)) & FORBIDDEN
        assert not bad, (f, bad)
        if not f.name.startswith("test_"):
            assert "benchmarks/" not in f.read_text(), f


@pytest.mark.parametrize("module", ["reference.py", "check.py", "work.py",
                                    "traffic.py", "weights.py"])
def test_yardstick_imports_nothing_of_the_port(module):
    names = set(_imports(BENCH_DIR / "harness" / module))
    assert "repro_torch" not in names and not names & FORBIDDEN

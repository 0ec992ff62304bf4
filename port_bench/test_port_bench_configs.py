"""The benchmark's configuration files: every published number kept under
its own key, the port's ModelConfig built from them at the source's
widths, the cuts listed in ``reduced`` and nothing else changed, and each
``not_modelled`` key present and unchanged."""
import pytest

from harness.spec import BENCH_DIR, port_config_kwargs, read_json, reader_path

BENCHMARK = read_json(BENCH_DIR.parent / "BENCHMARK.json")
CONFIGS = {c["name"]: c for c in BENCHMARK["configs"]}

# the catalog's DeepSeek-V2 entry (its ``config``), as published at
# https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json
DEEPSEEK_V2 = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 5120, "intermediate_size": 12288, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1536, "moe_layer_freq": 1, "n_group": 8,
    "n_routed_experts": 160, "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 128, "num_experts_per_tok": 6,
    "num_hidden_layers": 60, "num_key_value_heads": 128, "q_lora_rank": 1536,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 16, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 3,
    "topk_method": "group_limited_greedy", "v_head_dim": 128,
    "vocab_size": 102400}
# Qwen3-235B-A22B as published (no catalog row):
# https://huggingface.co/Qwen/Qwen3-235B-A22B/blob/main/config.json
QWEN3_235B = {
    "attention_bias": False, "decoder_sparse_step": 1, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 12288,
    "max_position_embeddings": 40960, "mlp_only_layers": [],
    "moe_intermediate_size": 1536, "norm_topk_prob": True,
    "num_attention_heads": 64, "num_experts": 128, "num_experts_per_tok": 8,
    "num_hidden_layers": 94, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "tie_word_embeddings": False,
    "vocab_size": 151936}
SOURCES = {"dsv2-l6": DEEPSEEK_V2, "qwen3-moe-l8": QWEN3_235B}

# the widths a configuration may never change (ModelConfig field: the
# published key it takes)
WIDTHS = ("d_model", "num_heads", "num_kv_heads", "head_dim", "vocab",
          "moe_experts", "moe_top_k", "moe_d_ff", "moe_shared_experts",
          "mla_kv_lora", "mla_q_lora", "mla_qk_nope_dim", "mla_qk_rope_dim",
          "mla_v_head_dim")


def _file(name):
    return read_json(BENCH_DIR / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_file_keeps_every_published_key(name):
    cfg, src = _file(name), SOURCES[name]
    reduced = set(cfg["reduced_from"])
    for key, value in src.items():
        assert key in cfg, key
        if key in reduced:
            assert cfg["reduced_from"][key] == value
            assert cfg[key] != value
        else:
            assert cfg[key] == value, key


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_modelconfig_at_the_sources_widths(name):
    from repro_torch.configs.base import ModelConfig
    cfg = _file(name)
    kw = port_config_kwargs(cfg)
    mc = ModelConfig(**kw)
    frm = cfg["port"]["from_config"]
    for field_, key in frm.items():
        assert getattr(mc, field_) == cfg[key], field_
    # no width comes from the file's own settings, and each mapped width
    # is the published one
    assert not set(cfg["port"]["set"]) & set(WIDTHS) - {"moe_shared_experts"}
    for field_ in WIDTHS:
        if field_ in frm:
            assert getattr(mc, field_) == SOURCES[name][frm[field_]]
    assert mc.num_layers == cfg["num_hidden_layers"]
    assert mc.dtype == cfg["torch_dtype"] == "bfloat16"


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_not_modelled_keys_exist_unchanged(name):
    cfg = _file(name)
    reduced = set(cfg["reduced_from"])
    assert cfg["not_modelled"]
    for key in cfg["not_modelled"]:
        assert key in cfg and key not in reduced, key
        assert cfg[key] == SOURCES[name].get(key, cfg[key])


def test_benchmark_names_its_files():
    for c in BENCHMARK["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert _file(c["name"])["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(_file(c["name"])["reduced_from"])
    for w in BENCHMARK["workloads"]:
        assert w["config"] in CONFIGS and w["chips"] == 1
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "cells" / f"{w['name']}.json").is_file()
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert reader_path(BENCH_DIR, m["name"]).is_file()

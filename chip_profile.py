#!/usr/bin/env python3
"""Where the port's serve path spends its time on one card.

    python3 chip_profile.py

Builds qwen2.5-3b at full width (random weights from a seed), one
Replica (32 slots, 2048 positions, 256-token prefill chunks) holding 16
sessions of 128-1024 prompt tokens, then traces with ``torch.profiler``:
5 fused decode rounds (a bucket of 16), then 3 prefill chunks of one
more admit, then, with the replica filled to its 32 slots, 5 fused
rounds of the full house (both decode windows report K3's share of the
device time), then one whole-prompt admit of 1024 tokens on a Replica
without prefill chunks (its attention on K5; the window reports K5's
share of the device time), after a warm-up admit.  Then internlm2-20b
at full size (48 layers, 48 query heads over 8 kv heads), one Replica (16
slots, 2048 positions) holding 16 sessions of 128-1024 prompt tokens: 5
fused decode rounds (K3's share, at g = 6).  Then falcon-mamba-7b
at full width (random weights from a seed), one Replica (16 slots)
holding 8 sessions of 128-1024 prompt tokens: one whole-prompt admit of
1024 tokens (its scans in K6; the window reports K6's share of the
device time), after a warm-up admit, then 3 fused lockstep decode
rounds.  Then zamba2-7b at full size (81 Mamba-2 layers, 14 shared-block
sites), one Replica (16 slots, 2048 positions): a whole-prompt admit of
1024 tokens after 14 sessions of 128-1024 tokens and a warm-up admit
(the shares of K5, at hd 112, and of the SSD), then 5 fused lockstep
rounds of the full house of 16 (the shares of K3 and the SSD).  Then
qwen3-moe-235b-a22b at full width and 8 layers, one Replica (16 slots,
256-token prefill chunks) holding 16 sessions: 5 fused rounds of 16 (the
shares of K3 and of the expert products).  Then deepseek-v2-236b at
full width and 6 layers, one Replica (16 slots, 2048 positions, whole
prompts) holding 15 sessions: a whole-prompt admit of 1024 tokens after a
warm-up admit (the shares of K5, at q . k 192 / v 128, and of the expert
products), then 5 fused rounds of the full house of 16 (the shares of the
absorbed decode and of the expert products).  Then whisper-small at full
size: a prefill of 8 streams of 1500 stub frames and 4-token prompts (K5's
share), then 5 lockstep decode steps (K3's share), each after a warm-up.
The SSD (``ssm._ssd_chunks``, ``ssm._ssd_step``), the expert products
(``layers._expert_ffn``) and MLA's absorbed decode
(``layers._mla_absorbed``) are wrapped in
``torch.profiler.record_function`` labels for those models' windows only
(the originals are restored after them), and their shares are the device
time of the kernels launched inside those labels; a label with no device
time fails the run.  Then one D1HT ``simulate_churn`` of the §VII churn cell
(n = 10^6, s_avg = 174 min, 1800 s window after 300 s, seed 1), after
one warm-up run: its host-side event stream (also timed alone) and
draws, K4 (the window reports its share) and the device metering.  Then
one training step of qwen2.5-3b at full size (bf16, remat full, AdamW, B 8
x S 1024 of ``SyntheticLM``), after a warm-up step: the shares of K5 (its
forward and remat recompute, ``flash_tc_kernel``), of K5b (its
``bwd_prep``, ``bwd_dkdv_wgmma`` and ``bwd_dq_wgmma`` kernels) and of the f32 logits'
forward (``layers.logits_fn`` under the label ``logits_f32``; their
backward runs outside it).  Then one training step each, after a
warm-up step, of the families ``chip_smoke.py`` trains (bf16, remat
full, AdamW, B 8): ``train_step_falcon``, falcon-mamba-7b at full width
and 32 of its 64 layers (S 1024; the shares of K6, ``ssm_scan_kernel``,
forward and remat recompute, and of K6b, ``ssm_scan_bwd_kernel`` and
``ssm_bwd_sum_kernel``); ``train_step_zamba2``, zamba2-7b at full width
and 36 of its 81 layers (S 1024; the SSD's label ``ssd``, K5 and K5b at
hd 112); ``train_step_whisper``, whisper-small at full size (1500 stub
frames, 448 tokens; K5 and K5b).  Prints
one JSON line per window: host wall time, device busy time (the union
of the kernels' intervals), the idle share, and the ops with the most
device time.  Needs a CUDA card; imports no jax.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOP = 12


def _busy_ms(events, labels=()) -> float:
    """The union of the device events' intervals; the device-side spans of
    the ``record_function`` labels (first to last kernel inside one, gaps
    included) are left out."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA" and e.name not in labels)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e3


@contextlib.contextmanager
def _labelled(module, label: str, *names: str):
    """Wrap ``module.<name>`` for each name in a ``record_function`` label
    while the block runs, and restore the originals after it.  Callers look
    the functions up in the module's globals, so they take the wrappers;
    ``_window`` fails when no kernel ran inside a label, so a caller that
    bound a function early cannot read as a share of 0."""
    import torch
    saved = {name: getattr(module, name) for name in names}

    def wrap(fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped
    try:
        for name, fn in saved.items():
            setattr(module, name, wrap(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _window(label: str, fn, steps: int, share_of: str = "",
            labels=(), shares=None, **extra) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _busy_ms(prof.events(), labels)
    rows = sorted((r for r in prof.key_averages() if r.key not in labels),
                  key=lambda r: -r.self_device_time_total)
    top = [{"op": r.key, "calls": r.count,
            "device_ms": r.self_device_time_total / 1e3 / steps}
           for r in rows[:TOP] if r.self_device_time_total > 0]
    if share_of:        # the device time of the ops whose name holds it
        ms = sum(r.self_device_time_total for r in rows
                 if share_of in r.key) / 1e3 / steps
        extra["share"] = {"ops_matching": share_of, "device_ms": ms,
                          "of_busy": ms * steps / busy if busy else None}
    for name, kernels in (shares or {}).items():   # kernels by name
        ms = sum(r.self_device_time_total for r in rows
                 if any(k in r.key for k in kernels)) / 1e3 / steps
        if not ms > 0:
            raise AssertionError(f"{label}: no device time in {kernels}")
        extra.setdefault("kernel_shares", {})[name] = {
            "device_ms": ms, "of_busy": ms * steps / busy if busy else None}
    for name in labels:     # the kernels launched inside these labels
        ms = sum(e.device_time_total for e in prof.events()
                 if e.name == name and e.device_type.name == "CPU") \
            / 1e3 / steps
        if not ms > 0:
            raise AssertionError(f"{label}: no device time inside the "
                                 f"{name!r} label")
        extra.setdefault("label_shares", {})[name] = {
            "device_ms": ms, "of_busy": ms * steps / busy if busy else None}
    print(json.dumps({"window": label, "steps": steps,
                      "wall_ms_per_step": wall / steps,
                      "device_busy_ms_per_step": busy / steps,
                      "idle_share": 1.0 - busy / wall, **extra,
                      "top_device_ops": top}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.churn import ChurnConfig
    from repro_torch.core.sim import _churn_event_stream, simulate_churn
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.backend import nvidia_smi_line
    from repro_torch.models import Model
    from repro_torch.models import layers, ssm
    from repro_torch.optim import adamw
    from repro_torch.runtime import Membership
    from repro_torch.serve import Replica, Request
    from repro_torch.train import TrainConfig, make_train_step

    dev = torch.device("cuda", 0)
    print(nvidia_smi_line(), flush=True)
    cfg = get_config("qwen2.5-3b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    mem = Membership(t_q=60.0, now=lambda: 0.0, device=dev)
    for i in range(4):
        mem.request_join(f"10.2.0.{i}", 9000)
    rep = Replica(model, slots=32, max_len=2048, prefill_chunk=256, device=dev)
    rep.attach_params(params)
    rng = np.random.default_rng(0)
    for i, n in enumerate(rng.integers(128, 1025, size=16)):
        rep.admit(Request(f"user-{i}", rng.integers(0, cfg.vocab, int(n),
                                                    dtype=np.int32)))
    route = mem.ring_state.device_bucket_table()
    for _ in range(2):                   # warm-up: allocator, cuBLAS plans
        rep.decode_round(route=route)
    _window("fused_decode_round_b16", lambda: rep.decode_round(route=route), 5,
            share_of="decode_")
    rep.begin_admit(Request("late", rng.integers(0, cfg.vocab, 1024,
                                                 dtype=np.int32)))
    rep.advance_prefills()               # warm-up chunk
    _window("prefill_chunk_256", rep.advance_prefills, 3)
    while "late" not in rep.sessions:   # the late admit's last chunks
        rep.advance_prefills()
    for i, n in enumerate(rng.integers(128, 1025, size=32 - len(rep.sessions))):
        rep.admit(Request(f"more-{i}", rng.integers(0, cfg.vocab, int(n),
                                                    dtype=np.int32)))
    assert len(rep.sessions) == 32
    for _ in range(2):                   # warm-up of the full house
        rep.decode_round(route=route)
    _window("fused_decode_round_b32", lambda: rep.decode_round(route=route), 5,
            share_of="decode_")
    del rep
    whole = Replica(model, slots=2, max_len=2048, prefill_chunk=None,
                    device=dev)
    whole.attach_params(params)
    admits = iter(Request(f"whole-{i}", rng.integers(0, cfg.vocab, 1024,
                                                     dtype=np.int32))
                  for i in range(2))
    whole.admit(next(admits))            # warm-up: a whole 1024-token admit
    _window("whole_prompt_admit_1024", lambda: whole.admit(next(admits)), 1,
            share_of="flash_")
    del whole, params, model
    torch.cuda.empty_cache()

    cfg = get_config("internlm2-20b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rep = Replica(model, slots=16, max_len=2048, prefill_chunk=256, device=dev)
    rep.attach_params(params)
    for i, n in enumerate(rng.integers(128, 1025, size=16)):
        rep.admit(Request(f"dense-{i}", rng.integers(0, cfg.vocab, int(n),
                                                     dtype=np.int32)))
    for _ in range(2):                   # warm-up rounds
        rep.decode_round(route=route)
    _window("internlm2_fused_decode_round_b16",
            lambda: rep.decode_round(route=route), 5, share_of="decode_")
    del rep, params, model
    torch.cuda.empty_cache()

    cfg = get_config("falcon-mamba-7b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rep = Replica(model, slots=16, max_len=2048, device=dev)
    rep.attach_params(params)
    for i, n in enumerate(rng.choice([128, 256, 512, 1024], size=8)):
        rep.admit(Request(f"ssm-{i}", rng.integers(0, cfg.vocab, int(n),
                                                   dtype=np.int32)))
    late = iter(Request(f"late-{i}", rng.integers(0, cfg.vocab, 1024,
                                                  dtype=np.int32))
                for i in range(2))
    rep.admit(next(late))                # warm-up: a 1024-token scan
    _window("ssm_admit_1024", lambda: rep.admit(next(late)), 1,
            share_of="ssm_scan")
    for _ in range(2):                   # warm-up rounds
        rep.decode_round(route=route)
    _window("ssm_fused_decode_round_b16", lambda: rep.decode_round(route=route),
            3)
    del rep, params, model
    torch.cuda.empty_cache()

    with _labelled(ssm, "ssd", "_ssd_chunks", "_ssd_step"):
        cfg = get_config("zamba2-7b")
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        rep = Replica(model, slots=16, max_len=2048, device=dev)
        rep.attach_params(params)
        for i, n in enumerate(rng.integers(128, 1025, size=14)):
            rep.admit(Request(f"hybrid-{i}", rng.integers(0, cfg.vocab, int(n),
                                                          dtype=np.int32)))
        late = iter(Request(f"late-{i}", rng.integers(0, cfg.vocab, 1024,
                                                      dtype=np.int32))
                    for i in range(2))
        rep.admit(next(late))                # warm-up: a whole 1024-token admit
        _window("zamba2_admit_1024", lambda: rep.admit(next(late)), 1,
                share_of="flash_", labels=("ssd",))
        assert len(rep.sessions) == 16
        for _ in range(2):                   # warm-up rounds
            rep.decode_round(route=route)
        _window("zamba2_fused_lockstep_round_b16",
                lambda: rep.decode_round(route=route), 5, share_of="decode_",
                labels=("ssd",))
    del rep, params, model
    torch.cuda.empty_cache()

    with _labelled(layers, "moe_experts", "_expert_ffn"):
        cfg = get_config("qwen3-moe-235b-a22b").with_overrides(num_layers=8)
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        rep = Replica(model, slots=16, max_len=2048, prefill_chunk=256, device=dev)
        rep.attach_params(params)
        for i, n in enumerate(rng.integers(128, 1025, size=16)):
            rep.admit(Request(f"moe-{i}", rng.integers(0, cfg.vocab, int(n),
                                                       dtype=np.int32)))
        for _ in range(2):                   # warm-up rounds
            rep.decode_round(route=route)
        _window("qwen3_moe_fused_decode_round_b16",
                lambda: rep.decode_round(route=route), 5, share_of="decode_",
                labels=("moe_experts",))
    del rep, params, model
    torch.cuda.empty_cache()

    with _labelled(layers, "moe_experts", "_expert_ffn"), \
            _labelled(layers, "mla_absorbed", "_mla_absorbed"):
        cfg = get_config("deepseek-v2-236b").with_overrides(num_layers=6)
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        rep = Replica(model, slots=16, max_len=2048, device=dev)
        rep.attach_params(params)
        for i, n in enumerate(rng.integers(128, 1025, size=14)):
            rep.admit(Request(f"mla-{i}", rng.integers(0, cfg.vocab, int(n),
                                                       dtype=np.int32)))
        late = iter(Request(f"late-{i}", rng.integers(0, cfg.vocab, 1024,
                                                      dtype=np.int32))
                    for i in range(2))
        rep.admit(next(late))                # warm-up: a whole 1024-token admit
        _window("deepseek_v2_admit_1024", lambda: rep.admit(next(late)), 1,
                share_of="flash_", labels=("moe_experts",))
        assert len(rep.sessions) == 16
        for _ in range(2):                   # warm-up rounds
            rep.decode_round(route=route)
        _window("deepseek_v2_fused_decode_round_b16",
                lambda: rep.decode_round(route=route), 5,
                labels=("mla_absorbed", "moe_experts"))
    del rep, params, model
    torch.cuda.empty_cache()

    cfg = get_config("whisper-small")
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, device=dev)
    frames = torch.randn((8, cfg.audio_frames, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    prompt = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (8, 4), dtype=np.int32)).to(dev), "frames": frames}
    state = {}

    def prefill():
        state["cache"] = model.init_cache(8, 448, device=dev)
        state["logits"], state["cache"] = model.prefill(params, prompt,
                                                        state["cache"])
        state["index"] = 4

    def step():
        tok = torch.argmax(state["logits"], dim=-1).to(torch.int32)[:, None]
        state["logits"], state["cache"] = model.decode_step(
            params, state["cache"], tok, state["index"])
        state["index"] += 1
    prefill()                            # warm-up
    _window("whisper_prefill_b8", prefill, 1, share_of="flash_")
    step()                               # warm-up
    _window("whisper_decode_step_b8", step, 5, share_of="decode_")
    del state, params, model, frames
    torch.cuda.empty_cache()
    cell = ChurnConfig(n=10**6, s_avg=174 * 60, duration=1800.0,
                       warmup=300.0, seed=1)
    simulate_churn(cell, device=dev)     # warm-up: CUDA module loading
    t0 = time.perf_counter()
    _churn_event_stream(cell, np.random.default_rng(cell.seed))
    stream_ms = (time.perf_counter() - t0) * 1e3
    _window("churn_d1ht_n1e6", lambda: simulate_churn(cell, device=dev), 1,
            share_of="edra_tree", host_event_stream_ms=stream_ms)

    cfg = get_config("qwen2.5-3b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_cfg = adamw.OptConfig(peak_lr=3e-4, warmup_steps=1, total_steps=1000)
    state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
    train_step = make_train_step(model, TrainConfig(opt=opt_cfg))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=1024, global_batch=8, seed=0)).batch(0).items()}

    def train():
        state["params"], state["opt"], _ = train_step(state["params"],
                                                      state["opt"], batch)
    train()                              # warm-up
    with _labelled(layers, "logits_f32", "logits_fn"):
        _window("train_step_qwen", train, 1, labels=("logits_f32",), shares={
            "K5": ("flash_tc_kernel<",),
            "K5b": ("bwd_prep_kernel<", "bwd_dkdv_wgmma_kernel<",
                    "bwd_dq_wgmma_kernel<")})
    del state, params, model, train_step
    torch.cuda.empty_cache()

    # the other families' training steps, as chip_smoke.py's train_ssm,
    # train_hybrid and train_encdec: falcon-mamba-7b at full width and 32
    # layers (K6, forward and remat recompute, and K6b, the scan and its
    # sums across blocks), zamba2-7b at full width and 36 layers (the
    # SSD's label, K5 and K5b at hd 112), whisper-small at full size (K5
    # and K5b)
    k5 = ("flash_tc_kernel<",)
    k5b = ("bwd_prep_kernel<", "bwd_dkdv_wgmma_kernel<", "bwd_dq_wgmma_kernel<")
    for window, arch, depth, seq, shares, labelled in (
            ("train_step_falcon", "falcon-mamba-7b", 32, 1024,
             {"K6": ("ssm_scan_kernel<",),
              "K6b": ("ssm_scan_bwd_kernel<", "ssm_bwd_sum_kernel<")}, ()),
            ("train_step_zamba2", "zamba2-7b", 36, 1024,
             {"K5": k5, "K5b": k5b}, ((ssm, "ssd", "_ssd_chunks"),)),
            ("train_step_whisper", "whisper-small", None, 448,
             {"K5": k5, "K5b": k5b}, ())):
        cfg = get_config(arch)
        if depth:
            cfg = cfg.with_overrides(num_layers=depth)
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        state = {"params": params, "opt": adamw.init_state(params, opt_cfg)}
        train_step = make_train_step(model, TrainConfig(opt=opt_cfg))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
            DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=8,
                       seed=0)).batch(0).items()}
        if cfg.family == "encdec":
            batch["frames"] = (torch.randn(
                (8, cfg.audio_frames, cfg.d_model), device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
                * 0.02).to(torch.bfloat16)
        train()                          # warm-up
        with contextlib.ExitStack() as stack:
            stack.enter_context(_labelled(layers, "logits_f32", "logits_fn"))
            for module, label, name in labelled:
                stack.enter_context(_labelled(module, label, name))
            _window(window, train, 1,
                    labels=("logits_f32",) + tuple(x[1] for x in labelled),
                    shares=shares)
        del state, params, model, train_step, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end training script of the port: a ~100M decoder-only LM on the
synthetic bigram stream, with checkpoint/restart fault tolerance (the
twin of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.train_lm --steps 300           # ~100M
    PYTHONPATH=src python -m repro_torch.train_lm --tiny --steps 60 --device cpu

Four ``Membership`` peers drive the trainer's ``ElasticController``; a
checkpoint is written every 50 steps into ``--ckpt-dir`` (by default a
fresh temporary directory, removed at the end).  Prints the example's
lines: the parameter count, each logged step, and the loss from the
first logged step to the last.  Weights are random from seed 0; the
model runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import torch

from .configs.base import ModelConfig
from .data import DataConfig, Prefetcher, SyntheticLM
from .kernels.backend import resolve_device
from .models import Model
from .optim import adamw
from .runtime import FailoverConfig, Membership
from .train.step import TrainConfig
from .train.trainer import Trainer, TrainerConfig


def model_100m() -> ModelConfig:
    # ~110M params: 12L x 768, GQA 12/4, ff 3072, 32k vocab
    return ModelConfig(name="lm-100m", family="dense", num_layers=12,
                       d_model=768, num_heads=12, num_kv_heads=4,
                       d_ff=3072, vocab=32768, remat="none", loss_chunk=128)


def model_tiny() -> ModelConfig:
    return ModelConfig(name="lm-tiny", family="dense", num_layers=4,
                       d_model=128, num_heads=4, num_kv_heads=2,
                       d_ff=512, vocab=2048, remat="none", loss_chunk=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_tiny() if args.tiny else model_100m()
    model = Model(cfg)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    membership = Membership(device=dev)
    for i in range(4):
        membership.request_join(f"10.0.0.{i}", 7000)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        trainer = Trainer(
            model,
            TrainerConfig(steps=args.steps, log_every=10,
                          train=TrainConfig(opt=adamw.OptConfig(
                              peak_lr=3e-4, warmup_steps=20,
                              total_steps=args.steps)),
                          failover=FailoverConfig(ckpt_dir,
                                                  save_every_steps=50)),
            membership=membership, model_axis=1, device=dev)

        data = Prefetcher(iter(SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
            seed=0))), depth=2)

        state = trainer.init_state(
            torch.Generator(device=dev).manual_seed(0))
        t0 = time.time()
        trainer.fit(state, data)
        for rec in trainer.history:
            print(rec)
        print(f"done in {time.time()-t0:.1f}s; "
              f"loss {trainer.history[0]['loss']:.3f} -> "
              f"{trainer.history[-1]['loss']:.3f}")
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

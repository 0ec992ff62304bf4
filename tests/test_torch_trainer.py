"""The port's ``Trainer`` and ``FailoverManager`` against repro's on the
CPU: ``Trainer.fit``'s logged losses, grad norms and learning rates for 6
steps of qwen2.5-3b's smoke() config in float32 from repro's weights and
the same ``SyntheticLM`` batches; the failover save/restore cycle of
``tests/test_runtime.py::test_failover_save_restore_cycle`` on the port's
``Membership``, ``ElasticController`` and checkpoints; a peer failing in
the middle of ``fit`` (the run restores its last checkpoint, bit for bit,
and finishes); and the ``train_lm`` twin at ``--tiny``.

Tolerances: the logged metrics within 1e-5 relative of repro's (f32
training on the same weights and batches, sums in another order)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import train_lm
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.runtime import (ElasticController, FailoverConfig,
                                 FailoverManager, Membership)
from repro_torch.train import TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

RTOL = 1e-5


def _members(n, cls=Membership, **kw):
    m = cls(t_q=60.0, now=lambda: 0.0, **kw)
    for i in range(n):
        m.request_join(f"10.0.0.{i}", 7000 + i)
    return m


def _opt(mod):
    return mod.OptConfig(peak_lr=3e-3, warmup_steps=2, total_steps=6)


def test_fit_logs_repros_losses():
    jcfg = j_smoke("qwen2.5-3b").with_overrides(dtype="float32")
    cfg = get_smoke_config("qwen2.5-3b").with_overrides(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(cfg)
    p = m.load(jax.device_get(jp), device="cpu")
    data = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)

    jt = JTrainer(jm, JTrainerConfig(steps=6, log_every=2, train=JTrainConfig(
        opt=_opt(jadamw))))
    jt.fit((jp, jadamw.init_state(jp, _opt(jadamw))),
           iter(JSyntheticLM(JDataConfig(**data))))
    t = Trainer(m, TrainerConfig(steps=6, log_every=2, train=TrainConfig(
        opt=_opt(adamw))), device="cpu")
    t.fit((p, adamw.init_state(p, _opt(adamw))),
          iter(SyntheticLM(DataConfig(**data))))
    assert [r["step"] for r in t.history] == [r["step"] for r in jt.history] \
        == [1, 2, 4, 6]
    for got, want in zip(t.history, jt.history):
        for key in ("loss", "grad_norm", "lr"):
            assert isinstance(got[key], float)
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=0, err_msg=key)
    assert t.history[-1]["loss"] < t.history[0]["loss"]


def test_failover_save_restore_cycle(tmp_path):
    m = _members(8, device="cpu")
    c = ElasticController(m, model_axis=1)
    f = FailoverManager(FailoverConfig(str(tmp_path), save_every_steps=2,
                                       keep_last=2), c)
    state = {"w": np.arange(10.0)}
    assert f.maybe_save(1, state) is None
    assert f.maybe_save(2, state) is not None
    assert not f.needs_restore()
    m.fail(m.members()[0])
    assert f.needs_restore()
    step, restored = f.restore_latest(state)
    assert step == 2
    np.testing.assert_array_equal(restored["w"], state["w"])
    assert not f.needs_restore()
    for s in (4, 6, 8):
        f.maybe_save(s, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_6", "step_8"]


def test_a_peer_failing_mid_fit_restores_the_last_checkpoint(tmp_path):
    """A peer fails during step 5 of 8 (checkpoints every 2): after step 5
    the trainer restores step 4 (params and moments equal to what step 4
    saved, bit for bit) and runs on to step 8."""
    cfg = get_smoke_config("qwen2.5-3b")
    members = _members(4, device="cpu")
    t = Trainer(Model(cfg), TrainerConfig(
        steps=8, log_every=1, train=TrainConfig(opt=_opt(adamw)),
        failover=FailoverConfig(str(tmp_path), save_every_steps=2)),
        membership=members, device="cpu")
    saved, restored = {}, {}
    save, restore = t.failover.maybe_save, t.failover.restore_latest

    def spy_save(step, state):
        path = save(step, state)
        if path:
            saved[step] = [x.clone() for x in adamw.leaves(state)]
        return path

    def spy_restore(target):
        step, state = restore(target)
        restored[step] = [x.clone() for x in adamw.leaves(state)]
        return step, state
    t.failover.maybe_save, t.failover.restore_latest = spy_save, spy_restore

    def batches():
        for i, b in enumerate(SyntheticLM(DataConfig(
                vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0))):
            if i == 4:                               # step 5 runs next
                members.fail(members.members()[-1])
            yield b
    t.fit(t.init_state(torch.Generator().manual_seed(0)), batches())
    assert list(restored) == [4]
    assert all(torch.equal(a, b) for a, b in zip(saved[4], restored[4]))
    steps = [r["step"] for r in t.history]
    assert steps == [1, 2, 3, 4, 4, 5, 6, 7, 8]


def test_train_lm_twin_runs_tiny(capsys):
    assert train_lm.main(["--tiny", "--steps", "3", "--seq", "32",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("lm-tiny: ") and lines[0].endswith("M params")
    assert lines[-1].startswith("done in ") and " -> " in lines[-1]
    assert len(lines) == 3                # the count, step 1, the summary

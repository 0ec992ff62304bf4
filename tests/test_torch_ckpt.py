"""The port's checkpoints (``repro_torch.ckpt``) in repro's on-disk format:
a roundtrip bit for bit (bf16, f32 and an int32 step), the manifest's
leaf paths and order equal to repro's for the same tree, a corrupt shard
and a foreign tree refused, ``latest_step`` skipping a torn ``.tmp``,
and each package restoring the other's checkpoint with a bf16 leaf,
exactly."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import get_smoke_config as j_smoke
from repro.models import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.optim import adamw

torch.set_num_threads(1)


def _state(seed=0):
    """A port train state of qwen2.5-3b's smoke() config in bf16, with
    non-zero moments and step."""
    m = Model(get_smoke_config("qwen2.5-3b"))
    p = m.init(torch.Generator().manual_seed(seed), device="cpu")
    opt = adamw.init_state(p, adamw.OptConfig())
    g = torch.Generator().manual_seed(seed + 1)
    for t in adamw.leaves(opt["m"]) + adamw.leaves(opt["v"]):
        t.copy_(torch.rand(t.shape, generator=g))
    opt["step"].fill_(17)
    return {"params": p, "opt": opt}


def _equal(a, b):
    la, lb = adamw.leaves(a), adamw.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_roundtrip_is_bit_exact_and_corruption_raises(tmp_path):
    state = _state()
    assert ckpt.latest_step(str(tmp_path)) is None
    path = ckpt.save(str(tmp_path), 7, state)
    assert ckpt.latest_step(str(tmp_path)) == 7
    os.makedirs(tmp_path / "step_9.tmp")            # a torn write is skipped
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored = ckpt.restore(str(tmp_path), 7, _state(seed=5))
    assert _equal(restored, state)
    assert restored["params"]["layers"]["attn"]["wq"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(str(tmp_path), 7, {"params": state["params"]})
    with open(os.path.join(path, "shard_0.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 7, state)


def test_manifest_matches_repros_for_the_same_tree(tmp_path):
    jcfg = j_smoke("qwen2.5-3b")
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jadamw.init_state(jp, jadamw.OptConfig())}
    m = Model(get_smoke_config("qwen2.5-3b"))
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    state = {"params": p, "opt": adamw.init_state(p, adamw.OptConfig())}
    jckpt.save(str(tmp_path / "j"), 1, jstate)
    ckpt.save(str(tmp_path / "t"), 1, state)
    man = [json.load(open(tmp_path / d / "step_1" / "manifest.json"))
           for d in ("j", "t")]
    assert man[0]["leaves"] == man[1]["leaves"]
    assert "['params']['layers']['attn']['wq']" in \
        [e["path"] for e in man[1]["leaves"]]


def test_each_package_restores_the_others_checkpoint(tmp_path):
    jcfg = j_smoke("qwen2.5-3b")
    jp = JModel(jcfg).init(jax.random.PRNGKey(3))
    jopt = jadamw.init_state(jp, jadamw.OptConfig())
    jopt["m"] = jax.tree.map(lambda x: x + 0.25, jopt["m"])
    jopt["step"] = jnp.asarray(11, jnp.int32)
    jstate = {"params": jp, "opt": jopt}
    port = _state(seed=2)

    # repro -> port
    jckpt.save(str(tmp_path / "j"), 4, jstate)
    got = ckpt.restore(str(tmp_path / "j"), 4, _state(seed=9))
    want = jax.device_get(jstate)
    for t, a in zip(adamw.leaves(got), jax.tree.leaves(want)):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    assert int(got["opt"]["step"]) == 11

    # port -> repro
    ckpt.save(str(tmp_path / "t"), 5, port)
    back = jax.device_get(jckpt.restore(str(tmp_path / "t"), 5, jstate))
    for a, t in zip(jax.tree.leaves(back), adamw.leaves(port)):
        a = np.asarray(a)
        if t.dtype == torch.bfloat16:
            assert a.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(
                a.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(a, t.numpy())


def test_numpy_leaves_roundtrip(tmp_path):
    state = {"w": np.arange(10.0), "n": {"i": np.arange(3, dtype=np.int32)}}
    ckpt.save(str(tmp_path), 2, state)
    out = ckpt.restore(str(tmp_path), 2, state)
    np.testing.assert_array_equal(out["w"], state["w"])
    assert out["n"]["i"].dtype == np.int32
    np.testing.assert_array_equal(out["n"]["i"], state["n"]["i"])

"""The port's EDRA collectives (``repro_torch.sharding.collectives``) against
repro's on the inputs of ``tests/test_sharding.py``: one subprocess runs
repro's ``edra_allgather``, ``edra_broadcast`` (sources 0, 3 and 7),
``edra_allreduce``, the data-parallel gradient sync and
``make_edra_allreduce`` on 8 forced host devices; the port runs the same
inputs as lists of per-peer tensors on 8 CPU entries.

The all-gather and the broadcast move values and must be equal; the
all-reduce and the gradient sync sum in another order (the port in peer
order 0 .. n-1) and must agree within 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sharding import collectives as jcoll
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import collectives as coll

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5

REPRO = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_host_mesh
from repro.sharding.collectives import (edra_allgather, edra_broadcast,
                                        edra_allreduce, make_edra_allreduce,
                                        shard_map_compat)
out = {}
mesh = jax.make_mesh((8,), ("d",))
x = jnp.arange(8 * 4, dtype=jnp.float32).reshape(8, 4)
ag = shard_map_compat(partial(edra_allgather, axis_name="d"), mesh,
                      in_specs=P("d", None), out_specs=P("d", None, None))
out["allgather"] = np.asarray(ag(x)).reshape(8, 8, 4)
for src in (0, 3, 7):
    bc = shard_map_compat(partial(edra_broadcast, axis_name="d", source=src),
                          mesh, in_specs=P("d", None), out_specs=P("d", None))
    out[f"broadcast{src}"] = np.asarray(bc(x))
ar = shard_map_compat(partial(edra_allreduce, axis_name="d"), mesh,
                      in_specs=P(None, None), out_specs=P(None, None))
y = jnp.arange(5 * 3, dtype=jnp.float32).reshape(5, 3)
out["allreduce"] = np.asarray(ar(y))

mesh = jax.make_mesh((8,), ("data",))
w = jnp.asarray(np.random.default_rng(0).standard_normal((16, 8)),
                jnp.float32)
xs = jnp.asarray(np.random.default_rng(1).standard_normal((32, 16)),
                 jnp.float32)
ys = jnp.asarray(np.random.default_rng(2).standard_normal((32, 8)),
                 jnp.float32)

def local_grad(w_, x_, y_):
    g = jax.grad(lambda wt: jnp.mean((x_ @ wt - y_) ** 2))(w_)
    return edra_allreduce(g, "data") / 8.0

sm = shard_map_compat(local_grad, mesh,
                      in_specs=(P(None, None), P("data", None),
                                P("data", None)),
                      out_specs=P(None, None))
out["grad_sync"] = np.asarray(jax.jit(sm)(w, xs, ys))
out["grad_full"] = np.asarray(jax.grad(
    lambda wt: jnp.mean((xs @ wt - ys) ** 2))(w))

tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
        "b": {"c": jnp.full((5,), 0.5, jnp.float32)}}
for axis in ("data", "model"):
    red = make_edra_allreduce(make_host_mesh(4), axis)(tree)
    out[f"tree_{axis}_a"] = np.asarray(red["a"])
    out[f"tree_{axis}_c"] = np.asarray(red["b"]["c"])
np.savez(sys.argv[1], **out)
print("COLLECTIVES_OK")
"""


@pytest.fixture(scope="module")
def repro_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("edra") / "repro.npz"
    res = subprocess.run(
        [sys.executable, "-c", REPRO, str(path)], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert "COLLECTIVES_OK" in res.stdout, res.stderr[-4000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _x():
    x = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    return [x[i:i + 1].clone() for i in range(8)]


def test_allgather_equals_repros(repro_out):
    got = coll.edra_allgather(_x())
    assert len(got) == 8
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy()[:, 0],
                                      repro_out["allgather"][i])


@pytest.mark.parametrize("source", [0, 3, 7])
def test_broadcast_equals_repros(repro_out, source):
    got = torch.cat(coll.edra_broadcast(_x(), source=source))
    np.testing.assert_array_equal(got.numpy(), repro_out[f"broadcast{source}"])
    np.testing.assert_array_equal(got.numpy(),
                                  np.tile(_x()[source].numpy(), (8, 1)))


def test_allreduce_matches_repros(repro_out):
    y = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    got = coll.edra_allreduce([y.clone() for _ in range(8)])
    for g in got:
        assert g.shape == y.shape
        np.testing.assert_allclose(g.numpy(), repro_out["allreduce"],
                                   rtol=0, atol=ATOL)


def test_gradient_sync_equals_the_whole_batch_gradient(repro_out):
    """Eight batch shards' gradients, synced by ``edra_allreduce`` / 8,
    equal the whole-batch gradient (``test_sharding.py``'s scenario)."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 8))
                         .astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((32, 16))
                         .astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(2).standard_normal((32, 8))
                         .astype(np.float32))
    grads = []
    for i in range(8):
        wi = w.clone().requires_grad_()
        loss = torch.mean((x[4 * i:4 * i + 4] @ wi - y[4 * i:4 * i + 4]) ** 2)
        grads.append(torch.autograd.grad(loss, [wi])[0])
    for g in coll.edra_allreduce(grads):
        g = (g / 8.0).numpy()
        np.testing.assert_allclose(g, repro_out["grad_sync"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(g, repro_out["grad_full"], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_tree_allreduce_over_a_mesh_axis_matches_repros(repro_out, axis):
    """``make_edra_allreduce`` on a (2, 4) mesh: each entry holds the same
    tree, as repro's replicated inputs, so each ring of the axis sums its
    peers' copies."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.full((5,), 0.5)}}
    reduce = coll.make_edra_allreduce(make_host_mesh(4, ["cpu"] * 8), axis)
    got = reduce([{"a": tree["a"].clone(), "b": {"c": tree["b"]["c"].clone()}}
                  for _ in range(8)])
    for t in got:
        np.testing.assert_allclose(t["a"].numpy(), repro_out[f"tree_{axis}_a"],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(t["b"]["c"].numpy(),
                                   repro_out[f"tree_{axis}_c"], rtol=0,
                                   atol=ATOL)


def test_tree_allreduce_sums_each_ring_of_the_axis():
    """Distinct trees: entry (i, j) of a (2, 4) mesh holds i * 4 + j; over
    ``data`` each entry gets its column's sum, over ``model`` its row's."""
    mesh = make_host_mesh(4, ["cpu"] * 8)
    trees = [{"v": torch.full((3,), float(e))} for e in range(8)]
    by_data = coll.make_edra_allreduce(mesh, "data")(trees)
    by_model = coll.make_edra_allreduce(mesh, "model")(trees)
    for e in range(8):
        i, j = divmod(e, 4)
        assert by_data[e]["v"].tolist() == [float(j + j + 4)] * 3
        assert by_model[e]["v"].tolist() == [float(sum(range(4 * i, 4 * i + 4)))] * 3
    with pytest.raises(ValueError, match="trees for a mesh of 8"):
        coll.make_edra_allreduce(mesh, "data")(trees[:4])


@pytest.mark.parametrize("n", [0, 3, 6])
def test_a_non_power_of_two_axis_raises_as_repro_does(n):
    with pytest.raises(ValueError) as want:
        jcoll._rounds(n) if n else jcoll._rounds(3)
    xs = [torch.zeros(2) for _ in range(n)]
    for fn in (coll.edra_allgather, coll.edra_broadcast, coll.edra_allreduce):
        with pytest.raises(ValueError, match="power-of-two axis") as got:
            fn(xs)
        if n:
            assert str(got.value) == str(want.value)


def test_rounds_are_shifts_by_powers_of_two(monkeypatch):
    """Each round of the all-gather sends peer i's buffer to (i + 2^l) % n
    (Rule 7): log2 n rounds of n sends, recorded through ``.to``."""
    sends = []
    real = torch.Tensor.to

    def spy(self, *args, **kwargs):
        sends.append(self.shape[0])
        return real(self, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "to", spy)
    coll.edra_allgather(_x())
    # round l ships sets of 2^l blocks, n = 8 of them a round
    assert sends == [1] * 8 + [2] * 8 + [4] * 8


def test_collectives_keep_each_peer_on_its_entry():
    xs = [torch.full((2,), float(i), dtype=torch.float64) for i in range(4)]
    for out in (coll.edra_allgather(xs), coll.edra_broadcast(xs, 2),
                coll.edra_allreduce(xs)):
        assert all(o.device == x.device and o.dtype == x.dtype
                   for o, x in zip(out, xs))
    assert coll.edra_allreduce(xs)[3].tolist() == [6.0, 6.0]

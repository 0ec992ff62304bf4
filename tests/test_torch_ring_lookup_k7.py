"""Port K7 (single-word ring lookup) plain version against repro's Pallas
``ring_lookup_pallas`` in interpret mode, as ``tests/test_kernels.py``
runs it: exact equality on its sweep shapes, its boundary keys, tables
with duplicate words, and against numpy's ``searchsorted(..., "left") %
N``.  An empty table raises ``LookupError`` in both packages.  Words
cross between the packages as numpy uint32; the port carries them as
int32 tensors holding the same bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ring_lookup.kernel import ring_lookup_pallas
from repro.kernels.ring_lookup.ops import ring_lookup as repro_ring_lookup
from repro_torch.kernels.ring_lookup import ops
from repro_torch.kernels.ring_lookup.ref import ring_lookup_ref

torch.set_num_threads(1)

RNG = np.random.default_rng(42)


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy())


def _both(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """K7's plain version and the public wrapper on CPU tensors, held to
    repro's Pallas kernel in interpret mode and to numpy; returns the
    indices."""
    keys, table = np.asarray(keys, np.uint32), np.asarray(table, np.uint32)
    want = np.asarray(ring_lookup_pallas(jnp.asarray(keys), jnp.asarray(table),
                                         interpret=True))
    got = ring_lookup_ref(_t(keys), _t(table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.searchsorted(table, keys, side="left") % table.size)
    before = ops.ring_lookup.launches
    np.testing.assert_array_equal(ops.ring_lookup(_t(keys), _t(table)).numpy(),
                                  want)
    assert ops.ring_lookup.launches == before     # no kernel on the CPU
    return want


@pytest.mark.parametrize("n,q", [(7, 3), (100, 257), (4096, 1024),
                                 (50_000, 2048)])
def test_ring_lookup_sweep(n, q):
    table = np.sort(RNG.choice(2**32 - 1, size=n, replace=False)
                    ).astype(np.uint32)
    keys = RNG.integers(0, 2**32, size=q, dtype=np.uint32)
    _both(keys, table)


def test_ring_lookup_boundary_keys():
    table = np.sort(RNG.choice(2**32 - 1, size=64, replace=False)
                    ).astype(np.uint32)
    keys = np.concatenate([table, table + 1, table - 1,
                           [0, 2**32 - 1]]).astype(np.uint32)
    _both(keys, table)


DUPLICATE_TABLES = {
    "runs": lambda: np.sort(np.repeat(
        RNG.integers(0, 2**32, size=40, dtype=np.uint32), 1 + np.arange(40) % 5)),
    "all_equal": lambda: np.full(33, 0xDEADBEEF, np.uint32),
    "ends": lambda: np.array([0, 0, 0, 5, 5, 2**32 - 1, 2**32 - 1], np.uint32),
    "single": lambda: np.array([2**31], np.uint32),
}


@pytest.mark.parametrize("name", sorted(DUPLICATE_TABLES))
def test_ring_lookup_duplicate_words(name):
    """A run of equal words gives its first index (bisect_left), and the
    top half of the uint32 range sorts above the bottom."""
    table = DUPLICATE_TABLES[name]()
    keys = np.concatenate([table, table + 1, table - 1, [0, 1, 2**31 - 1,
                           2**31, 2**32 - 1],
                           RNG.integers(0, 2**32, size=64, dtype=np.uint32)]
                          ).astype(np.uint32)
    idx = _both(keys, table)
    first = {int(w): int(np.argmax(table == w)) for w in np.unique(table)}
    hit = np.isin(keys, table)
    np.testing.assert_array_equal(idx[hit],
                                  [first[int(k)] for k in keys[hit]])


def test_ring_lookup_empty_table_raises_in_both():
    keys = np.arange(4, dtype=np.uint32)
    empty = np.zeros(0, np.uint32)
    with pytest.raises(LookupError, match="empty routing table"):
        repro_ring_lookup(jnp.asarray(keys), jnp.asarray(empty))
    with pytest.raises(LookupError, match="empty routing table"):
        ops.ring_lookup(_t(keys), _t(empty))
    # before any device work: a table on the meta device never reaches
    # a launcher
    with pytest.raises(LookupError, match="empty routing table"):
        ops.ring_lookup(torch.empty(4, dtype=torch.int32, device="meta"),
                        torch.empty(0, dtype=torch.int32, device="meta"))

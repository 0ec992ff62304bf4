"""Static cost of a step, counted on a torch trace (the port's counterpart
of ``repro.launch.hlo_cost``, under the same file name so a reader finds
it).

``repro`` walks the compiled HLO text of a jitted step.  The port has no
HLO: it runs eager aten ops, so ``CostCounter`` (a
``TorchDispatchMode``) counts the same three roofline inputs on the ops a
call dispatches, on any device, ``meta`` included:

  * matmul FLOPs   — every ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``
                     (an ``einsum`` or ``matmul`` reaches the counter as
                     these), by ``torch.utils.flop_counter``'s formulas;
  * HBM bytes      — operands plus result at every aten op that is not a
                     view or an allocation: each eager op is a round trip
                     through memory, as a fusion's boundary is in
                     ``repro``'s model.  A fill (``zeros``, ``full``,
                     ``fill_``) writes its result only; ``copy_`` reads its
                     source and writes its destination;
  * collective bytes — by op kind under ``repro``'s names (``all-gather``,
                     ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
                     ``collective-permute``): the result bytes of a
                     ``torch.distributed`` functional collective, or what
                     the port's own collectives charge.

and a fourth that HLO has no need of:

  * kernel charges — a hand-written kernel (K3, K5, K5b, K6, K6b) is
                     opaque to a dispatch mode, so its wrapper charges the
                     work the function needs, from shapes alone
                     (``kernels.backend.charged`` with the ``*_work``
                     function of its ``ops.py``), and the counter hides the
                     aten ops the wrapper runs meanwhile (allocations,
                     alignment copies).  A charge is the same on the card
                     and on ``meta``, so one program counts the same on
                     both: nothing counted depends on a tensor's values or
                     its device.

The totals (``matmul_flops``, ``hbm_bytes``) include the kernels'
charges; ``aten`` and ``kernels`` give the parts.  The counter also keeps
the high-water mark of live tensors that are not the call's arguments
(``temp_bytes``): each tensor storage an op returns is live from that op
until Python frees it, the autograd graph's saved tensors included.

The port's loops run in Python, so there is no trip count to recover: a
loop of ten products dispatches ten ``mm``.
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
# ops that only name memory (a view ``is_view`` does not flag) or only make it
_NO_TRAFFIC = {"_unsafe_view", "empty", "empty_like", "empty_strided",
               "new_empty", "new_empty_strided", "empty_permuted",
               "resize_", "set_"}
# ops that write their result and read nothing
_WRITE_ONLY = {"zeros", "zeros_like", "ones", "ones_like", "full",
               "full_like", "new_zeros", "new_ones", "new_full", "arange",
               "fill_", "zero_", "scalar_tensor"}
# torch.distributed's functional collectives, by repro's names
_C10D = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    and results)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


@functools.lru_cache(maxsize=None)
def _kind(func) -> str:
    """How an op is counted: ``none`` (a view, an allocation), ``write``
    (its result only), ``copy`` (source and destination), ``matmul``
    (FLOPs, and operands plus result), a collective's name (its result,
    and operands plus result), or ``full`` (operands plus result)."""
    name = func._schema.name.split("::")[-1]
    if func.namespace == "_c10d_functional" and name in _C10D:
        return _C10D[name]
    if func.is_view or name in _NO_TRAFFIC:
        return "none"
    if func.overloadpacket in _MATMULS:
        return "matmul"
    if name in _WRITE_ONLY:
        return "write"
    return "copy" if name == "copy_" else "full"


def _bytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class CostCounter(TorchDispatchMode):
    """Counts a block's matmul FLOPs, HBM bytes, collective bytes by op
    kind and kernel charges, and its peak of live non-argument bytes:

        with CostCounter(arguments=(params, batch)) as c:
            step(params, batch)
        c.result()

    ``arguments``: any tree of tensors the block is given (their storages
    are never counted as temporaries)."""

    def __init__(self, arguments: Any = ()) -> None:
        super().__init__()
        self.aten_matmul_flops = 0
        self.aten_hbm_bytes = 0
        self.collective_bytes_by_op: Dict[str, float] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.hidden = 0               # > 0 inside a kernel's or a collective's charge
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}   # id of a live storage -> bytes
        self._arguments = WeakIdKeyDictionary()
        for t in _tensors(arguments):
            self._arguments[t.untyped_storage()] = True

    # -- charges (``kernels.backend.charged``) -------------------------------
    def charge(self, name: str, work: Dict[str, Any]) -> None:
        """Add a kernel's work (numeric entries summed under ``name``, with
        a call count), or a collective's bytes under its kind."""
        kind = work.get("collective")
        if kind is not None:
            if kind not in COLLECTIVES:
                raise ValueError(f"collective {kind!r}: not one of "
                                 f"{COLLECTIVES}")
            self.collective_bytes_by_op[kind] = \
                self.collective_bytes_by_op.get(kind, 0) + work["bytes"]
            return
        row = self.kernels.setdefault(name, {"calls": 0})
        row["calls"] += 1
        for key, value in work.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                row[key] = row.get(key, 0) + value

    # -- the dispatch hook ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(outs)
        if not self.hidden:
            self._count(func, args, kwargs, out, outs)
        return out

    def _count(self, func, args, kwargs, out, outs) -> None:
        kind = _kind(func)
        if kind == "none" or not outs:
            return
        if kind in COLLECTIVES:
            self.collective_bytes_by_op[kind] = \
                self.collective_bytes_by_op.get(kind, 0) + _bytes(outs)
            kind = "full"
        elif kind == "matmul":
            self.aten_matmul_flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        if kind == "write":
            self.aten_hbm_bytes += _bytes(outs)
        elif kind == "copy":
            self.aten_hbm_bytes += _bytes(_tensors(args[:2]))
        else:
            self.aten_hbm_bytes += _bytes(_tensors(args)) \
                + _bytes(_tensors(kwargs)) + _bytes(outs)

    def _track(self, outs) -> None:
        """Each new storage among ``outs`` is live until Python frees it."""
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages or st in self._arguments:
                continue
            n = st.nbytes()
            self._storages[key] = n
            weakref.finalize(st, self._free, key)
            self.live_bytes += n
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key)

    # -- the result -----------------------------------------------------------
    def kernel_total(self, key: str) -> float:
        return sum(row.get(key, 0) for row in self.kernels.values())

    @property
    def matmul_flops(self) -> float:
        return self.aten_matmul_flops + self.kernel_total("matmul_flops")

    @property
    def hbm_bytes(self) -> float:
        return self.aten_hbm_bytes + self.kernel_total("bytes")

    def result(self) -> Dict[str, Any]:
        """``repro``'s keys (``matmul_flops``, ``hbm_bytes``,
        ``collective_bytes_by_op``, ``collective_bytes``,
        ``arithmetic_intensity``), and the parts: the aten ops' FLOPs and
        bytes, the kernels' charges, their other operations, and the peak
        of live temporaries (``temp_bytes``)."""
        coll = dict(self.collective_bytes_by_op)
        return {
            "matmul_flops": self.matmul_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes_by_op": coll,
            "collective_bytes": sum(coll.values()),
            "arithmetic_intensity":
                self.matmul_flops / max(float(self.hbm_bytes), 1.0),
            "aten": {"matmul_flops": self.aten_matmul_flops,
                     "hbm_bytes": self.aten_hbm_bytes},
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "other_ops": self.kernel_total("ops"),
            "temp_bytes": self.peak_bytes,
        }


def fn_cost(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` under a ``CostCounter`` whose arguments
    are ``args`` and ``kwargs``, and return its ``result()`` (``repro``'s
    keys and the parts).  On ``meta`` tensors nothing is allocated or
    run; on the card the call runs (time it elsewhere: the counter's
    Python hook costs host time at every op)."""
    with CostCounter((args, kwargs)) as counter:
        fn(*args, **kwargs)
    return counter.result()

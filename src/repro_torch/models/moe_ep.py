"""Expert-parallel MoE with an explicit all-to-all dispatch (the port of
``repro.models.moe_ep``).

``repro``'s block runs under ``shard_map`` on its mesh; here one process
drives every shard of the installed mesh (``sharding.specs.mesh_context``,
a ``launch.mesh.DeviceMesh``) in turn, single-controller:

  * tokens are sharded over BOTH mesh axes: shard (i, j) owns batch rows
    i·B/D .. (i+1)·B/D and sequence positions j·S/M .. (j+1)·S/M,
    flattened row-major to (T_loc, d);
  * routing is computed per shard; slots are binned by destination EP
    shard into fixed-capacity buffers (c2 = ceil(T_loc·k·cf / M) each);
  * one all-to-all of each data row (the transpose of its (source,
    destination) grid of (c2, d) blocks, each block moved to its
    receiver's entry) ships rows to expert owners, a local stable sort
    and capacity c3 = ceil(M·c2 / e_loc) place them into (e_loc, c3, d)
    slabs for batched products, and the reverse all-to-all brings the
    outputs home;
  * every step is a torch op, so autograd differentiates the block (the
    all-to-all's backward is the reverse all-to-all);
  * each all-to-all charges an active cost counter (``launch.hlo_cost``)
    with the bytes its receivers take in, summed over the shards, as
    ``all-to-all`` (``repro``'s ``lax.all_to_all``).

Expert ownership is contiguous: shard j owns experts j·e_loc ..
(j+1)·e_loc (``flat_ids // e_loc``), as ``repro``'s code has it.  The ring
enters only through ``runtime.placement.Placement.expert_permutation``,
which a caller may apply to the stacked expert weights (``repro``'s
docstring says the D1HT ring owns the experts; its code does not).

Deliberate differences from ``repro``: the combine gathers each token's k
results and adds them in choice order (``repro`` scatter-adds them: the
same sums, and on the card a deterministic order where an atomic
scatter-add is not); a batch that the data axis does not divide raises
ValueError before any work (``repro``'s ``shard_map`` raises); and int8
experts under a mesh raise ValueError (``repro``'s EP products read the
int8 weights without their scales).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.backend import charge
from ..sharding import specs as sh
from . import layers as L

Params = Dict[str, Any]

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def capacities(t_loc: int, cfg: ModelConfig, m_shards: int) -> Tuple[int, int]:
    """(c2, c3): the slots a shard sends each destination, and the slots
    of each local expert's slab."""
    e_loc = cfg.moe_experts // m_shards
    c2 = max(1, int(math.ceil(t_loc * cfg.moe_top_k * cfg.moe_capacity_factor
                              / m_shards)))
    c3 = max(1, int(math.ceil(m_shards * c2 * 1.0 / e_loc)))
    return c2, c3


def _bins(key: torch.Tensor, n_bins: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of ``key`` (values in 0 .. n_bins, n_bins = empty) and
    each sorted entry's slot ``bin * cap + rank``; an empty entry or a
    rank past ``cap`` gets the cut-off slot ``n_bins * cap`` (``repro``'s
    out-of-bounds drop).  Returns (order, slot)."""
    order = torch.argsort(key, stable=True)
    skey = key[order]
    starts = torch.searchsorted(
        skey, torch.arange(n_bins, device=key.device, dtype=key.dtype))
    rank = torch.arange(key.shape[0], device=key.device) \
        - starts[skey.clamp(max=n_bins - 1)]
    ok = (rank < cap) & (skey < n_bins)
    slot = torch.where(ok, skey * cap + rank,
                       torch.full_like(rank, n_bins * cap))
    return order, slot


def _scatter_rows(src: torch.Tensor, index: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """(n, d) rows: row ``index[r]`` is ``src[r]``, the rest zeros; an
    index of n (the cut-off row) drops its source row.  Every row is
    moved by a scatter (``index_copy``), whose backward is a gather: no
    gradient is accumulated, where a gather with a zero fill row would
    sum every empty slot's gradient into that one row."""
    out = src.new_zeros((n + 1, src.shape[1]))
    return out.index_copy(0, index, src)[:n]


def _slot_index(order: torch.Tensor, slot: torch.Tensor, n_slots: int,
                fill: int) -> torch.Tensor:
    """The entry (an index into the unsorted rows) each of ``n_slots``
    slots holds, ``fill`` where a slot is empty."""
    idx = torch.full((n_slots + 1,), fill, dtype=torch.int64,
                     device=order.device)
    return idx.scatter_(0, slot, order)[:n_slots]


def _route(x_loc: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1's gate: the router cast to the input dtype, upcast exactly
    and multiplied in f32 (``repro``'s product with f32 accumulation),
    softmax, top-k (``layers._top_k``), renormalised and cast to the
    input dtype.  Returns (weights, ids), each (T_loc, k)."""
    gate = torch.matmul(x_loc.float(), router.to(x_loc.dtype).float())
    weights, ids = L._top_k(torch.softmax(gate, dim=-1), cfg.moe_top_k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights.to(x_loc.dtype), ids


def _dispatch(ids: torch.Tensor, m_shards: int, e_loc: int, c2: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1's bins: (the send slot of each (token, choice) in flat
    order, m_shards * c2 where dropped; the (token, choice) each of the
    m_shards * c2 send slots holds, t * k where empty; each slot's local
    expert at its destination, e_loc where empty)."""
    t, k = ids.shape
    flat_ids = ids.reshape(t * k)
    order, slot = _bins(flat_ids // e_loc, m_shards, c2)
    slot_of_flat = torch.empty_like(slot).scatter_(0, order, slot)
    flat_of_slot = _slot_index(order, slot, m_shards * c2, t * k)
    send_e = flat_ids.new_full((m_shards * c2 + 1,), e_loc).scatter_(
        0, slot_of_flat, flat_ids % e_loc)[:m_shards * c2]
    return slot_of_flat, flat_of_slot, send_e


def _experts(rows: torch.Tensor, eids: torch.Tensor, w1, w2, w3,
             cfg: ModelConfig, e_loc: int, c3: int) -> torch.Tensor:
    """Phase 2 on one shard: the received rows (M * c2, d) placed by a
    stable sort into (e_loc, c3, d) slabs (a row past c3 dropped), the
    local experts' FFNs, and each row's output back in its place (zeros
    where empty or dropped)."""
    n, d = rows.shape
    order2, slot2 = _bins(eids, e_loc, c3)
    slot_of_row = torch.empty_like(slot2).scatter_(0, order2, slot2)
    xin = _scatter_rows(rows, slot_of_row, e_loc * c3).reshape(e_loc, c3, d)
    act = L._ACTS[cfg.act]
    h = act(torch.bmm(xin, w1))
    if w3 is not None:
        h = h * torch.bmm(xin, w3)
    eout = torch.bmm(h, w2).reshape(e_loc * c3, d)
    return _scatter_rows(eout, _slot_index(order2, slot2, e_loc * c3, n), n)


def _shards(x: torch.Tensor, d_rows: int, m_shards: int) -> List[List]:
    """x (B, S, d) cut into the (d_rows, m_shards) grid of shards."""
    return [list(r.chunk(m_shards, dim=1)) for r in x.chunk(d_rows, dim=0)]


def moe_block_ep(params: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Optional[torch.Tensor]:
    """EP all-to-all MoE over the installed mesh.  Returns None, and the
    caller runs ``layers.moe_block``, where ``repro``'s falls back: no
    mesh, no "model" axis, or experts or sequence not divisible by the
    model axis."""
    mesh = sh.current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    m_shards = mesh.shape["model"]
    b, s, d = x.shape
    if cfg.moe_experts % m_shards or s % m_shards:
        return None
    if cfg.act not in L._ACTS:
        raise NotImplementedError(f"activation {cfg.act}")
    batch_axis = sh.logical_spec("batch")[0]
    if batch_axis != "data":
        raise ValueError(f"moe_block_ep: the batch over {batch_axis!r}; "
                         f"takes it over 'data' (the default rules)")
    d_rows = mesh.shape["data"]
    if b % d_rows:
        raise ValueError(f"moe_block_ep: a batch of {b} rows does not split "
                         f"over {d_rows} data shards")
    if params["w1"].dtype == torch.int8:
        raise ValueError("moe_block_ep: int8 experts under a mesh (repro's "
                         "EP products read them without their scales)")
    e_loc, k = cfg.moe_experts // m_shards, cfg.moe_top_k
    t_loc = b // d_rows * (s // m_shards)
    c2, c3 = capacities(t_loc, cfg, m_shards)
    # each shard's experts, split once (the backward stacks the shards'
    # gradients, where a slice a shard would zero-fill the whole stack)
    w = [params[n].chunk(m_shards) if n in params else [None] * m_shards
         for n in ("w1", "w2", "w3")]

    rows_out = []
    for i, xs in enumerate(_shards(x, d_rows, m_shards)):
        devs = mesh.devices[i]
        # phase 1: each shard routes and bins its own tokens
        sent, plans = [], []
        for j, xj in enumerate(xs):
            x_loc = xj.to(devs[j]).reshape(-1, d)
            weights, ids = _route(x_loc, params["router"].to(devs[j]), cfg)
            slot_of_flat, flat_of_slot, send_e = _dispatch(ids, m_shards,
                                                           e_loc, c2)
            send_x = _scatter_rows(
                x_loc[:, None].expand(t_loc, k, d).reshape(t_loc * k, d),
                slot_of_flat, m_shards * c2).reshape(m_shards, c2, d)
            sent.append((send_x.unbind(0), send_e.reshape(m_shards, c2)))
            plans.append((weights, flat_of_slot))
        # the all-to-all: destination j receives block j of every source;
        # phase 2: each shard runs its experts on what it received
        outs = []
        charge("moe_ep", {"collective": "all-to-all", "bytes": sum(
            sum(_nbytes(t) for t in xs_) + _nbytes(e) for xs_, e in sent)})
        for j in range(m_shards):
            recv_x = torch.cat([sent[src][0][j].to(devs[j])
                                for src in range(m_shards)])
            recv_e = torch.cat([sent[src][1][j].to(devs[j])
                                for src in range(m_shards)])
            wj = [None if ws[j] is None else ws[j].to(devs[j]) for ws in w]
            outs.append(_experts(recv_x, recv_e, *wj, cfg, e_loc,
                                 c3).reshape(m_shards, c2, d).unbind(0))
        # the reverse all-to-all, then phase 3: each shard adds its
        # tokens' k results in choice order
        row = []
        charge("moe_ep", {"collective": "all-to-all", "bytes": sum(
            _nbytes(t) for o in outs for t in o)})
        for j in range(m_shards):
            back = torch.cat([outs[dst][j].to(devs[j])
                              for dst in range(m_shards)])
            weights, flat_of_slot = plans[j]
            vals = _scatter_rows(back, flat_of_slot, t_loc * k) \
                .reshape(t_loc, k, d)
            out = torch.zeros((t_loc, d), dtype=x.dtype, device=devs[j])
            for c in range(k):
                out = out + vals[:, c] * weights[:, c:c + 1]
            row.append(out.reshape(xs[j].shape).to(x.device))
        rows_out.append(torch.cat(row, dim=1))
    out = torch.cat(rows_out, dim=0)

    if cfg.moe_shared_experts:
        act = L._ACTS[cfg.act]
        hs = act(x @ params["sw1"])
        if "sw3" in params:
            hs = hs * (x @ params["sw3"])
        out = out + hs @ params["sw2"]
    return out


def dropped_slots(ids: Sequence[torch.Tensor], cfg: ModelConfig,
                  m_shards: int) -> Tuple[int, int]:
    """The slots one data row's block drops, from its shards' top-k ids
    ((T_loc, k) each, in shard order, as ``layers._top_k`` gave them):
    (past c2 at the senders, past c3 at the experts' slabs)."""
    e_loc = cfg.moe_experts // m_shards
    c2, c3 = capacities(ids[0].shape[0], cfg, m_shards)
    sends = [_dispatch(t, m_shards, e_loc, c2) for t in ids]
    over2 = sum(int((sof == m_shards * c2).sum()) for sof, _, _ in sends)
    over3 = 0
    for j in range(m_shards):
        eids = torch.cat([e.reshape(m_shards, c2)[j] for _, _, e in sends])
        _, slot2 = _bins(eids, e_loc, c3)
        over3 += int((eids < e_loc).sum()) - int((slot2 < e_loc * c3).sum())
    return over2, over3

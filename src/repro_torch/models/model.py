"""Model facade of the port (``repro.models.model.Model``): the dense,
MoE, MLA and VLM families (``transformer``), the SSM and hybrid families
(``hybrid``: Mamba-1 or Mamba-2 layers, zamba2's shared attention block),
and the encoder-decoder (``encdec``, whisper).

    m = Model(cfg)
    params = m.init(generator, device=...)      # random weights on device
    params = m.load(tree_of_numpy, device=...)  # repro's weights
    cache = m.init_cache(batch, max_len, device=...)
    logits, cache = m.prefill(params, {"tokens": t}, cache)
    # encdec: {"tokens", "frames"}; vlm: {"tokens", "image_embeds"}
    logits, cache = m.decode_step(params, cache, tokens, index)

``device=None`` means the CUDA card and raises without one; pass
``device="cpu"`` to run on the host with the kernels' plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.backend import resolve_device, strict_fp32
from . import convert, encdec, hybrid, transformer

Params = Dict[str, Any]


def _module(cfg: ModelConfig):
    """The family's module, as ``repro.models.model._module``; what is not
    ported yet raises, naming its ROADMAP item."""
    if cfg.family == "encdec":
        return encdec
    if cfg.family in ("ssm", "hybrid"):
        return hybrid
    if cfg.moe_experts and cfg.moe_impl == "ep":
        raise NotImplementedError("the expert-parallel MoE (moe_impl='ep') "
                                  "is not ported yet: ROADMAP queue 1, "
                                  "item 4")
    return transformer


def _on(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32()
    return dev


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self) -> None:
        _module(self.cfg)

    # -- parameters ----------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, *,
             device=None) -> Params:
        """Random weights drawn on the device (seed 0 by default)."""
        dev = _on(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return _module(self.cfg).init_params(self.cfg, generator, dev)

    def load(self, tree: Dict[str, Any], *, device=None) -> Params:
        """``repro``'s parameter tree, as numpy, onto the device."""
        return convert.params_from_jax(tree, self.cfg, _on(device))

    # -- serving ---------------------------------------------------------------
    @property
    def supports_per_slot_decode(self) -> bool:
        """decode_step accepts a (B,) per-slot index tensor (the dense,
        MoE, MLA and VLM families; the SSM, hybrid and encoder-decoder
        families decode in lockstep)."""
        return _module(self.cfg) is transformer

    @property
    def supports_chunked_prefill(self) -> bool:
        """prefill_chunk can continue a prefill mid-cache (the dense, MoE
        and VLM families; MLA's latent cache has no continuation path,
        and an SSM, hybrid or encoder-decoder prefill is one whole
        prompt)."""
        return _module(self.cfg) is transformer and not self.cfg.mla_kv_lora

    def init_cache(self, batch: int, max_len: int, *, device=None):
        """Dense, MoE and VLM: the KV cache for ``max_len`` positions;
        MLA: the latent ``c`` / ``r`` cache; SSM: the recurrent state,
        whose size does not depend on ``max_len``; hybrid: the state and
        the shared sites' KV cache; encoder-decoder: the self KV cache and
        the cross K/V of ``audio_frames`` positions."""
        return _module(self.cfg).init_cache(self.cfg, batch, max_len,
                                            _on(device))

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache) -> Tuple[torch.Tensor, Any]:
        """Process the prompt, filling the cache from position 0.  The
        encoder-decoder takes ``batch["frames"]`` (B, T, d) and the VLM
        ``batch["image_embeds"]`` (B, vision_tokens, d), as ``repro``."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.forward_with_cache(params, batch["tokens"], cache,
                                             cfg, 0, frames=batch["frames"])
        if cfg.family == "vlm":
            return transformer.forward_with_cache(
                params, batch["tokens"], cache, cfg, 0,
                image_embeds=batch["image_embeds"])
        return _module(cfg).forward_with_cache(
            params, batch["tokens"], cache, cfg, 0)

    def prefill_chunk(self, params: Params, tokens: torch.Tensor, cache,
                      index: int) -> Tuple[torch.Tensor, Any]:
        """One fixed-shape prefill segment from cache position ``index``;
        returns ALL-position logits (B, S, V).  Dense, MoE and VLM (text)
        only."""
        if not self.supports_chunked_prefill:
            raise NotImplementedError(
                f"family {self.cfg.family} has no chunked prefill")
        return transformer.forward_with_cache(params, tokens, cache, self.cfg,
                                              index, chunk=True)

    def decode_step(self, params: Params, cache, tokens: torch.Tensor,
                    index) -> Tuple[torch.Tensor, Any]:
        """One token per sequence.  ``index`` is the current cache length:
        an int steps every row in lockstep; a (B,) tensor steps each slot
        at its OWN position (each < max_len; only when
        ``supports_per_slot_decode``)."""
        return _module(self.cfg).forward_with_cache(params, tokens, cache,
                                                    self.cfg, index)

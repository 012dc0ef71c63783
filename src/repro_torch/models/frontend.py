"""Modality frontends: stubs, as in the reference.

Counterpart of ``repro/models/frontend.py``.  The ``[audio]`` and
``[vlm]`` architectures specify the transformer backbone only; the
modality encoder (EnCodec, CLIP-ViT) is out of scope.  These helpers
splice precomputed frame or patch embeddings into the token stream, so
the backbone sees an ordinary [B, S, d_model] sequence
(``transformer.forward(..., embeds=)``).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def audio_frontend(params, codes, cfg):
    """MusicGen-style: EnCodec codes are discrete tokens; the frontend is
    the embedding table, returned as embeddings."""
    return L.embed(params["embed"], codes).to(cfg.activation_dtype)


def vision_frontend(params, tokens, patch_embeds, cfg):
    """LLaVA-NeXT-style: precomputed patch embeddings [B, P, D] prepended
    to the embedded text tokens [B, S_text, D]."""
    text = L.embed(params["embed"], tokens)
    return torch.cat([patch_embeds.to(text.dtype), text], 1).to(
        cfg.activation_dtype)

"""Slot-softmax cross-attention, the Retriever's core — the plain PyTorch
version.

Counterpart of ``slotvps_tpu/ops/pallas/slot_attention.py``
``slot_attention_pallas`` and the oracle of the Hopper kernel
(``ops/cuda/slot_attention.py``):

    out[b, l] = sum_p softmax over l (q[b, l] . k[b, p]) * v[b, p]

with the TPU kernel's numerics: the scores are f32 sums of products of the
inputs (bf16 products are exact in f32), the softmax over the slot axis is
per pixel and in f32, the probabilities stay f32 in the product with v,
and the output is f32.  Each pixel's softmax is complete in itself, so the
sum over pixels can be taken in any tiling.

This is not the ``"jax"`` route's ``retriever_attention``
(``models/slot_head.py``), which keeps the attention tensor in the
activations' dtype.
"""

from __future__ import annotations

import torch


def slot_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """q [B, L, C], k and v [B, P, C] -> out [B, L, C] f32."""
    scores = q.float() @ k.float().transpose(1, 2)      # [B, L, P]
    return torch.softmax(scores, dim=1) @ v.float()

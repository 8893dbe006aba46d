"""The port's numeric setup on the card: full-precision reductions.

PyTorch's defaults let cuDNN run f32 convolutions in TF32 (about three
decimal digits) and let cuBLAS reduce bf16 products in bf16.  The JAX
package asks for f32 accumulation everywhere
(``preferred_element_type=jnp.float32``), so the port's entry points turn
those shortcuts off with :func:`setup_precision`.  The model code itself
(``InferencePipeline`` included) never changes these process-wide flags:
a caller that builds its own pipeline calls this function first.
"""

from __future__ import annotations

import torch


def setup_precision() -> None:
    """f32 convolutions and matmuls in full f32; bf16 products reduced in
    f32.  Sets process-wide flags; needs no CUDA device."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

"""slotvps_tpu_torch — the PyTorch/CUDA port of slotvps_tpu.

The port imports ``torch`` and never ``jax``.  It reuses the JAX-free
shared code of :mod:`slotvps_tpu` as is (``config``, ``data``, ``eval``,
``tracking``, ``native``) and mirrors the JAX package's module paths, so
``slotvps_tpu_torch.models.detector`` is the counterpart of
``slotvps_tpu.models.detector``.  Activations keep the JAX package's NHWC
layout at every public function; parameters are stored in torch layout
(conv OIHW, linear ``[out, in]``).  ``utils/convert.py`` maps a JAX
parameter tree onto the port's modules.
"""

"""slotvps_tpu_torch — the PyTorch/CUDA port of slotvps_tpu.

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package: it keeps its own copies of the JAX-free modules it needs
(``config``, ``tracking``, ``data``, ``eval``, ``utils/charts``,
``native``), with the same names and behaviour.  It mirrors the JAX
package's module paths, so ``slotvps_tpu_torch/models/detector.py`` is the
counterpart of ``slotvps_tpu/models/detector.py``.  Activations keep the
JAX package's NHWC layout at every public function; parameters are stored
in torch layout (conv OIHW, linear ``[out, in]``).  ``utils/convert.py``
maps a JAX parameter tree onto the port's modules.
"""

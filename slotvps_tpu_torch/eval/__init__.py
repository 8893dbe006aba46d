"""The port's copy of the JAX package's host-side evaluation
(``slotvps_tpu/eval/{color,fusion,vpq}.py``): panoptic fusion, tube-id
colour assignment and VPQ, same names, same behaviour, numpy only."""

"""The port's copy of the JAX package's test-time data path
(``slotvps_tpu/data/{pipeline,dataset,loader}.py``): same names, same
behaviour, numpy only."""

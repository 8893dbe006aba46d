"""The port's copy of the JAX package's data path
(``slotvps_tpu/data/{pipeline,dataset,loader,transforms,mask,sampler}.py``):
same names, same behaviour, numpy (and cv2 for the train pipeline) only."""

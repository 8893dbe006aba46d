"""The plain reference that decides ``correct``: a frozen copy, in plain
PyTorch, of the plain routes of ``slotvps_tpu_torch`` at commit
86b90feb98325982c750f329cf213fa73d0ed5b3 (R50, Swin-L, FPN, the semantic
head on the plain DCN, the decoder on the plain Retriever, the track head,
the reference postprocess and the host tracking).  It imports nothing of
the port; each file's header names the port file it copies."""

"""MemEC on PyTorch + hand-written CUDA kernels.

The port of the JAX package ``repro`` (kept beside it as the reference):
``core`` (the single-shard cluster and its coding engine), ``kernels``
(the CUDA kernels and their plain torch versions), ``data`` (YCSB) and
``configs`` (the paper's testbed).  It imports torch and numpy only.
"""

"""SharesSkew on PyTorch and CUDA.

The same layout as ``repro`` (the JAX reference package): ``core`` plans,
``data`` generates relations, ``mapreduce`` maps, bins and joins, and
``kernels`` holds the hand-written CUDA kernels with their plain PyTorch
versions; ``configs``, ``models`` and ``serve`` are the dense transformer
and its serving engine.  Entry points run on ``device="cuda"`` unless told
otherwise and raise when no card is present.
"""

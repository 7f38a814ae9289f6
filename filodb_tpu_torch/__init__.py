"""filodb-tpu on PyTorch and CUDA: the port of the ``filodb_tpu`` query path
to an NVIDIA Hopper card.

The package mirrors ``filodb_tpu``'s module paths (core, memstore, query,
ops, coordinator) and imports nothing of it, nor JAX. Its entry point,
``coordinator.planner.QueryEngine``, runs on the card unless the caller
passes ``device="cpu"``; the range function runs in the hand-written
kernel ``csrc/window_stats.cu`` (``ops/window_stats.py``).
"""

__version__ = "0.1.0"

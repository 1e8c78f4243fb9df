"""Auto-SpMV on PyTorch + CUDA (NVIDIA Hopper).

The port of the ``repro`` package (JAX + Pallas), one slice at a time, with
the same sub-package layout and the same module and function names. It
imports ``torch`` and ``numpy`` only. Entry points that touch tensors take
``device=``; ``None`` means ``"cuda"`` and raises where CUDA is absent.
"""

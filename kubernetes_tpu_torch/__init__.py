"""kubernetes_tpu_torch — the batched scheduling backend in PyTorch and CUDA.

A port of ``kubernetes_tpu`` (JAX) that imports nothing from it. The layout
mirrors the JAX package (``api/``, ``framework/``, ``cache/``, ``ops/``,
``backend/``, ``utils/``); the fused per-pod commit step is a CUDA kernel
(``csrc/fused_step.cu``) with a plain PyTorch version beside it
(``ops/fused_step.py``). Entry points take an explicit ``device``; without
one they run on the CUDA card and raise when there is none.
"""

"""PyTorch and CUDA port of the ``repro`` package for one NVIDIA H100.

It mirrors ``repro``'s layout (``configs``, ``core``, ``models``,
``kernels``, ``launch``, ``data``) and imports nothing of it, nor JAX.
"""

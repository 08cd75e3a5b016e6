"""Hand-written Hopper kernels of the port (``csrc/*.cu``), their ctypes
wrappers, their plain PyTorch versions (``ref``) and the dispatch between
them (``ops``). Importing builds nothing: ``build`` compiles at first use."""

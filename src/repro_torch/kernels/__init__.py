"""Hand-written Hopper kernels (``csrc/*.cu``), their bindings, their plain
PyTorch versions (``ref``) and the public wrappers (``ops``)."""

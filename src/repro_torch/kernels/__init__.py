"""Hand-written Hopper kernels (``csrc/``), their wrappers, their plain
PyTorch versions (``ref``) and the dispatch between them (``ops``)."""

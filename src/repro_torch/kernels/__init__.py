"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref``) and the dispatch between them (``ops``)."""

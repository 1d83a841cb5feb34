"""The plain reference of each configuration's forward pass.

Plain PyTorch in float32 (TF32 off), one full causal forward over a
sequence, with no kernel, cache or batching of the port.  A configuration
file names its module here under ``"reference"``.  Nothing here imports
JAX, the JAX package or anything of ``repro_torch``: the reference reads
only the weights the benchmark made and the tokens it is given.
"""

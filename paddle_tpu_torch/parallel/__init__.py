"""Parallel building blocks of the port: the MoE layer (``moe``) and the
tensor-parallel collectives and rings (``collective_matmul``)."""

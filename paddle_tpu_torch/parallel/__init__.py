"""Parallel building blocks of the port: the MoE layer (``moe``), the
tensor-parallel collectives and rings (``collective_matmul``) and the
pipeline schedules (``pipeline``)."""

"""Test harnesses of the port: deterministic fault injection
(:mod:`.faults`)."""
from . import faults  # noqa: F401

"""Parallel building blocks of the port (single-device pieces so far)."""

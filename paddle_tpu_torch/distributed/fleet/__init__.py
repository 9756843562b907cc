"""Hybrid-parallel topology of the port (``fleet.topology``)."""
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]

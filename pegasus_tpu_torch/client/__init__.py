"""The Pegasus client: PegasusClient over a StaticResolver (a meta-server
resolver comes with the meta slice)."""

from .client import PegasusClient, PegasusError, Scanner, StaticResolver

__all__ = ["PegasusClient", "PegasusError", "Scanner", "StaticResolver"]

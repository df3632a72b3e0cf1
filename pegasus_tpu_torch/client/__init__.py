"""The Pegasus client: PegasusClient over a StaticResolver (a fixed
partition map) or a MetaResolver (the partition table from the meta,
refreshed on reconfiguration), and the client factory."""

from .client import PegasusClient, PegasusError, Scanner, StaticResolver
from .factory import close_all, get_client
from .meta_resolver import MetaResolver

__all__ = ["PegasusClient", "PegasusError", "Scanner", "StaticResolver",
           "MetaResolver", "get_client", "close_all"]

from .meta_server import MetaServer

__all__ = ["MetaServer"]

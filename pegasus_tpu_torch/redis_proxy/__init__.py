"""The RESP proxy over the pegasus client (port of
pegasus_tpu/redis_proxy/)."""

from .proxy import RedisProxy

__all__ = ["RedisProxy"]

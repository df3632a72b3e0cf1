from .crc64 import crc64, crc64_batch
from .key_schema import (check_key_hash, expire_ts_from_ttl, generate_key,
                         generate_next_bytes, key_hash, restore_key)
from .utils import c_escape_string, epoch_begin, epoch_now
from .value_schema import check_if_ts_expired

__all__ = [
    "crc64",
    "crc64_batch",
    "generate_key",
    "generate_next_bytes",
    "key_hash",
    "epoch_now",
    "epoch_begin",
    "check_if_ts_expired",
    "check_key_hash",
    "expire_ts_from_ttl",
    "restore_key",
    "c_escape_string",
]

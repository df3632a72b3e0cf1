from .crc64 import crc64, crc64_batch
from .key_schema import generate_key, generate_next_bytes, key_hash
from .utils import epoch_begin, epoch_now
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
]

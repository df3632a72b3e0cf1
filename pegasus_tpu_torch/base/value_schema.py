"""Pegasus value schemas v0/v1/v2, byte-identical to the reference formats.

The port's own copy of pegasus_tpu/base/value_schema.py (same schemas,
timetag layout and dispatch), so both packages write the same value bytes.

v0 (src/base/pegasus_value_schema.h:164-179):
    value = [expire_ts (uint32 BE)] [user_data]
v1 (src/base/pegasus_value_schema.h:211-232), adds the duplication timetag:
    value = [expire_ts (uint32 BE)] [timetag (uint64 BE)] [user_data]
    timetag = (timestamp_us << 8) | (cluster_id << 1) | deleted_tag
v2 (src/base/value_schema_v2.cpp:65-92), self-describing:
    value = [0x80|2 (uint8)] [expire_ts (uint32 BE)] [timetag (uint64 BE)] [user_data]

expire_ts is seconds since 2016-01-01 UTC (see utils.epoch_begin); 0 = no TTL.
Dispatch (src/base/value_schema_manager.cpp:42-64): first byte & 0x80 set →
per-record version in the low 7 bits (unknown → latest, forward-compat);
otherwise the table-level data_version from the meta store decides.
"""

import struct
from dataclasses import dataclass

TIMESTAMP_MASK = 0xFFFFFFFFFFFFFF  # 56 bits


def generate_timetag(timestamp_us: int, cluster_id: int, deleted_tag: bool) -> int:
    """src/base/pegasus_value_schema.h:43-46."""
    return ((timestamp_us & TIMESTAMP_MASK) << 8) | ((cluster_id & 0x7F) << 1) | int(deleted_tag)


def extract_timestamp_from_timetag(timetag: int) -> int:
    return (timetag >> 8) & TIMESTAMP_MASK


def extract_cluster_id_from_timetag(timetag: int) -> int:
    return (timetag >> 1) & 0x7F


def extract_deleted_from_timetag(timetag: int) -> bool:
    return bool(timetag & 1)


@dataclass
class ValueFields:
    """Decoded value: the typed fields of src/base/value_field.h:24-59."""

    expire_ts: int
    timetag: int  # 0 for v0
    user_data: bytes
    version: int


class ValueSchemaV0:
    VERSION = 0
    HEADER = 4

    def generate_value(self, expire_ts: int, timetag: int, user_data: bytes) -> bytes:
        return struct.pack(">I", expire_ts) + user_data

    def extract_expire_ts(self, value: bytes) -> int:
        return struct.unpack_from(">I", value, 0)[0]

    def extract_timetag(self, value: bytes) -> int:
        return 0

    def extract_user_data(self, value: bytes) -> bytes:
        return value[self.HEADER :]

    def update_expire_ts(self, value: bytes, new_expire_ts: int) -> bytes:
        return struct.pack(">I", new_expire_ts) + value[4:]

    def extract_fields(self, value: bytes) -> ValueFields:
        return ValueFields(self.extract_expire_ts(value), 0, self.extract_user_data(value), 0)


class ValueSchemaV1(ValueSchemaV0):
    VERSION = 1
    HEADER = 12

    def generate_value(self, expire_ts: int, timetag: int, user_data: bytes) -> bytes:
        return struct.pack(">IQ", expire_ts, timetag) + user_data

    def extract_timetag(self, value: bytes) -> int:
        return struct.unpack_from(">Q", value, 4)[0]

    def extract_fields(self, value: bytes) -> ValueFields:
        return ValueFields(
            self.extract_expire_ts(value),
            self.extract_timetag(value),
            self.extract_user_data(value),
            1,
        )


class ValueSchemaV2:
    VERSION = 2
    HEADER = 13

    def generate_value(self, expire_ts: int, timetag: int, user_data: bytes) -> bytes:
        return struct.pack(">BIQ", 0x80 | self.VERSION, expire_ts, timetag) + user_data

    def extract_expire_ts(self, value: bytes) -> int:
        return struct.unpack_from(">I", value, 1)[0]

    def extract_timetag(self, value: bytes) -> int:
        return struct.unpack_from(">Q", value, 5)[0]

    def extract_user_data(self, value: bytes) -> bytes:
        return value[self.HEADER :]

    def update_expire_ts(self, value: bytes, new_expire_ts: int) -> bytes:
        return value[:1] + struct.pack(">I", new_expire_ts) + value[5:]

    def extract_fields(self, value: bytes) -> ValueFields:
        return ValueFields(
            self.extract_expire_ts(value),
            self.extract_timetag(value),
            self.extract_user_data(value),
            2,
        )


SCHEMAS = {0: ValueSchemaV0(), 1: ValueSchemaV1(), 2: ValueSchemaV2()}
LATEST_VERSION = max(SCHEMAS)


class ValueSchemaManager:
    """First-byte dispatch registry (src/base/value_schema_manager.cpp:26-77)."""

    def get_value_schema(self, meta_cf_data_version: int, value: bytes):
        if value and value[0] & 0x80:
            version = value[0] & 0x7F
            # forward-compat: unknown per-record version falls back to latest
            return SCHEMAS.get(version, SCHEMAS[LATEST_VERSION])
        schema = SCHEMAS.get(meta_cf_data_version)
        if schema is None:
            raise ValueError(f"data version({meta_cf_data_version}) in meta cf is not supported")
        return schema

    def get_latest_value_schema(self):
        return SCHEMAS[LATEST_VERSION]


def check_if_ts_expired(epoch_now: int, expire_ts: int) -> bool:
    """src/base/pegasus_value_schema.h:119-122: 0 means no TTL."""
    return 0 < expire_ts <= epoch_now

"""Wire message types: the rrdb data surface and the compaction-offload
plane.

Port of pegasus_tpu/rpc/messages.py: the rrdb data messages (KeyRequest
through ScanResponse, bulk-load ingest, duplicate, trigger-audit) with
their enums, and the subset the offload service and its client speak.
Field names, types, defaults and ORDER are those of the JAX package,
trailing fields included: the codec (rpc/codec.py) writes fields by
position, so a field moved, inserted or retyped still round-trips inside
one package but breaks against the other. Error codes in responses follow
the storage-status numbering (Status).

A compaction-offload tenant ships packed runs (content-addressed,
chunked, CRC-checked), the service merges them on its device and the
tenant fetches the merged output back. Block identity is a
LearnBlockEntry (name + size + content digest); chunk fetches answer with
a LearnFetchResponse (data + crc + total).
"""

import enum
from dataclasses import dataclass, field
from typing import List, Optional

class Status(enum.IntEnum):
    """Storage status codes carried in response.error."""

    OK = 0
    NOT_FOUND = 1
    CORRUPTION = 2
    NOT_SUPPORTED = 3
    INVALID_ARGUMENT = 4
    IO_ERROR = 5
    INCOMPLETE = 7
    TRY_AGAIN = 13


class FilterType(enum.IntEnum):  # rrdb.thrift:23-29
    NO_FILTER = 0
    MATCH_ANYWHERE = 1
    MATCH_PREFIX = 2
    MATCH_POSTFIX = 3


class CasCheckType(enum.IntEnum):  # rrdb.thrift:31-59
    NO_CHECK = 0
    VALUE_NOT_EXIST = 1
    VALUE_NOT_EXIST_OR_EMPTY = 2
    VALUE_EXIST = 3
    VALUE_NOT_EMPTY = 4
    VALUE_MATCH_ANYWHERE = 5
    VALUE_MATCH_PREFIX = 6
    VALUE_MATCH_POSTFIX = 7
    VALUE_BYTES_LESS = 8
    VALUE_BYTES_LESS_OR_EQUAL = 9
    VALUE_BYTES_EQUAL = 10
    VALUE_BYTES_GREATER_OR_EQUAL = 11
    VALUE_BYTES_GREATER = 12
    VALUE_INT_LESS = 13
    VALUE_INT_LESS_OR_EQUAL = 14
    VALUE_INT_EQUAL = 15
    VALUE_INT_GREATER_OR_EQUAL = 16
    VALUE_INT_GREATER = 17


class MutateOperation(enum.IntEnum):  # rrdb.thrift:61-65
    PUT = 0
    DELETE = 1


@dataclass
class KeyRequest:
    """Single-key request body (the reference passes a raw blob for
    get/remove/ttl; sortkey_count passes the hash_key blob)."""

    key: bytes = b""


@dataclass
class UpdateRequest:  # update_request
    key: bytes
    value: bytes
    expire_ts_seconds: int = 0


@dataclass
class UpdateResponse:  # update_response
    error: int = 0
    app_id: int = 0
    partition_index: int = 0
    decree: int = 0
    server: str = ""


@dataclass
class ReadResponse:  # read_response
    error: int = 0
    value: bytes = b""
    app_id: int = 0
    partition_index: int = 0
    server: str = ""


@dataclass
class TTLResponse:  # ttl_response
    error: int = 0
    ttl_seconds: int = 0
    app_id: int = 0
    partition_index: int = 0
    server: str = ""


@dataclass
class CountResponse:  # count_response
    error: int = 0
    count: int = 0
    app_id: int = 0
    partition_index: int = 0
    server: str = ""


@dataclass
class KeyValue:  # key_value
    key: bytes
    value: bytes = b""
    expire_ts_seconds: Optional[int] = None


@dataclass
class MultiPutRequest:  # multi_put_request
    hash_key: bytes
    kvs: List[KeyValue] = field(default_factory=list)
    expire_ts_seconds: int = 0


@dataclass
class MultiRemoveRequest:  # multi_remove_request
    hash_key: bytes
    sort_keys: List[bytes] = field(default_factory=list)
    max_count: int = 0  # deprecated upstream


@dataclass
class MultiRemoveResponse:  # multi_remove_response
    error: int = 0
    count: int = 0
    app_id: int = 0
    partition_index: int = 0
    decree: int = 0
    server: str = ""


@dataclass
class MultiGetRequest:  # multi_get_request
    hash_key: bytes
    sort_keys: List[bytes] = field(default_factory=list)
    max_kv_count: int = 0
    max_kv_size: int = 0
    no_value: bool = False
    start_sortkey: bytes = b""
    stop_sortkey: bytes = b""
    start_inclusive: bool = True
    stop_inclusive: bool = False
    sort_key_filter_type: int = FilterType.NO_FILTER
    sort_key_filter_pattern: bytes = b""
    reverse: bool = False


@dataclass
class MultiGetResponse:  # multi_get_response
    error: int = 0
    kvs: List[KeyValue] = field(default_factory=list)
    app_id: int = 0
    partition_index: int = 0
    server: str = ""


@dataclass
class IncrRequest:  # incr_request
    key: bytes
    increment: int = 0
    expire_ts_seconds: int = 0  # 0 keep ttl; >0 reset; <0 clear


@dataclass
class IncrResponse:  # incr_response
    error: int = 0
    new_value: int = 0
    app_id: int = 0
    partition_index: int = 0
    decree: int = 0
    server: str = ""


@dataclass
class CheckAndSetRequest:  # check_and_set_request
    hash_key: bytes
    check_sort_key: bytes = b""
    check_type: int = CasCheckType.NO_CHECK
    check_operand: bytes = b""
    set_diff_sort_key: bool = False
    set_sort_key: bytes = b""
    set_value: bytes = b""
    set_expire_ts_seconds: int = 0
    return_check_value: bool = False


@dataclass
class CheckAndSetResponse:  # check_and_set_response
    error: int = 0
    check_value_returned: bool = False
    check_value_exist: bool = False
    check_value: bytes = b""
    app_id: int = 0
    partition_index: int = 0
    decree: int = 0
    server: str = ""


@dataclass
class Mutate:  # mutate
    operation: int
    sort_key: bytes
    value: bytes = b""
    set_expire_ts_seconds: int = 0


@dataclass
class CheckAndMutateRequest:  # check_and_mutate_request
    hash_key: bytes
    check_sort_key: bytes = b""
    check_type: int = CasCheckType.NO_CHECK
    check_operand: bytes = b""
    mutate_list: List[Mutate] = field(default_factory=list)
    return_check_value: bool = False


@dataclass
class CheckAndMutateResponse:  # check_and_mutate_response
    error: int = 0
    check_value_returned: bool = False
    check_value_exist: bool = False
    check_value: bytes = b""
    app_id: int = 0
    partition_index: int = 0
    decree: int = 0
    server: str = ""


@dataclass
class GetScannerRequest:  # get_scanner_request
    start_key: bytes = b""
    stop_key: bytes = b""
    start_inclusive: bool = True
    stop_inclusive: bool = False
    batch_size: int = 1000
    no_value: bool = False
    hash_key_filter_type: int = FilterType.NO_FILTER
    hash_key_filter_pattern: bytes = b""
    sort_key_filter_type: int = FilterType.NO_FILTER
    sort_key_filter_pattern: bytes = b""
    validate_partition_hash: bool = True
    return_expire_ts: bool = False


@dataclass
class ScanRequest:  # scan_request
    context_id: int


@dataclass
class ScanResponse:  # scan_response
    error: int = 0
    kvs: List[KeyValue] = field(default_factory=list)
    context_id: int = 0
    app_id: int = 0
    partition_index: int = 0
    server: str = ""


@dataclass
class BulkLoadIngestRequest:
    """Replicated ingestion command: every replica of the partition reads
    the shared provider set and ingests it at the same decree, so
    bulk-loaded data survives failover."""

    provider_root: str = ""
    app_name: str = ""
    partition_count: int = 0


@dataclass
class BulkLoadIngestResponse:
    error: int = 0
    ingested_records: int = 0
    app_id: int = 0
    partition_index: int = 0
    decree: int = 0
    server: str = ""


@dataclass
class DuplicateRequest:  # duplicate_request
    timestamp: int = 0
    task_code: str = ""
    raw_message: bytes = b""
    cluster_id: int = 0
    verify_timetag: bool = False


@dataclass
class DuplicateResponse:  # duplicate_response
    error: int = 0
    error_hint: str = ""


@dataclass
class TriggerAuditRequest:
    """Admin no-op mutation: every replica computes an order-independent
    digest of its engine state at the decree this mutation applies at.
    `now` is the expiry clock the PRIMARY chose — all replicas filter
    TTL-expired records against the same instant, so clock skew cannot
    fake a mismatch. `pmask` (partition_count - 1) is the ownership
    mask the PRIMARY chose: every replica excludes records the
    partition no longer owns (split stale halves) against the SAME
    mask — the env-spread partition_version is asynchronous per
    replica, so anchoring the mask in the mutation is what keeps a
    digest during a split from faking a mismatch (append-only codec
    evolution: old senders leave it 0 = engine-local mask)."""

    audit_id: int = 0
    now: int = 0
    pmask: int = 0


@dataclass
class TriggerAuditResponse:
    error: int = 0
    app_id: int = 0
    partition_index: int = 0
    decree: int = 0            # the decree the digest is anchored at
    digest: str = ""           # 32-hex-char order-independent state digest
    records: int = 0           # live records folded into the digest
    server: str = ""


# ------------------------------------------------- block-shipped learn


@dataclass
class LearnBlockEntry:
    """One block in a manifest: filename + size + content digest."""

    name: str = ""
    size: int = 0
    digest: str = ""


@dataclass
class LearnPrepareRequest:
    """Manifest-diff handshake, learner -> primary: `have` is the
    learner's live block set; the primary pins an immutable checkpoint
    and answers with the full manifest plus which blocks are missing.
    delta=False ships everything regardless of `have`."""

    app_id: int = 0
    pidx: int = 0
    delta: bool = True
    have: List[LearnBlockEntry] = field(default_factory=list)
    job: str = ""              # the learner's job-trace id ("" untraced)


@dataclass
class LearnPrepareResponse:
    error: int = 0
    error_text: str = ""
    learn_id: int = 0          # pin handle for fetch/tail/finish
    ckpt_decree: int = 0       # the pinned checkpoint's manifest decree
    ballot: int = 0
    last_committed: int = 0
    blocks: List[LearnBlockEntry] = field(default_factory=list)
    missing: List[str] = field(default_factory=list)
    # decree-anchored digest of the pinned checkpoint plus the TTL clock
    # and ownership mask it was computed against: the learner proves the
    # shipped state on arrival
    digest: str = ""
    digest_now: int = 0
    digest_pmask: int = 0


@dataclass
class LearnFetchRequest:
    """One bounded chunk of one pinned block."""

    app_id: int = 0
    pidx: int = 0
    learn_id: int = 0
    name: str = ""
    offset: int = 0
    length: int = 0


@dataclass
class LearnFetchResponse:
    error: int = 0
    error_text: str = ""
    data: bytes = b""
    crc: int = 0               # crc32 of `data` (per-chunk integrity)
    total: int = 0             # whole-block size


@dataclass
class LearnTailRequest:
    app_id: int = 0
    pidx: int = 0
    learn_id: int = 0


@dataclass
class LearnTailResponse:
    error: int = 0
    error_text: str = ""
    tail: List[bytes] = field(default_factory=list)  # encoded LogMutations
    last_committed: int = 0
    ballot: int = 0


@dataclass
class LearnFinishRequest:
    """Release the learn pin (checkpoint and log GC resume)."""

    app_id: int = 0
    pidx: int = 0
    learn_id: int = 0


# ------------------------------------------------- compaction offload


@dataclass
class OffloadBeginRequest:
    """Open one merge job: the manifest of packed runs (newest first: run
    order IS merge priority) plus the merge options as JSON (the wire-safe
    CompactOptions subset; user rules and the default-TTL rewrite stay
    tenant-side)."""

    tenant: str = ""
    gpid: str = ""
    runs: List[LearnBlockEntry] = field(default_factory=list)
    opts_json: str = ""
    # trailing: the tenant's job-trace id ("" untraced)
    job: str = ""


@dataclass
class OffloadBeginResponse:
    error: int = 0
    error_text: str = ""
    job_id: int = 0
    # run names already fully staged (content-address hit from an earlier
    # interrupted ship or a sibling tenant): the resume/dedup set
    staged: List[str] = field(default_factory=list)


@dataclass
class OffloadShipRequest:
    """One bounded chunk of one packed run, written at its offset (chunks
    of a block may land out of order across the RPC pool)."""

    job_id: int = 0
    name: str = ""
    offset: int = 0
    data: bytes = b""
    crc: int = 0               # crc32 of `data`


@dataclass
class OffloadShipResponse:
    error: int = 0
    error_text: str = ""
    landed: bool = False       # block complete + whole-file digest verified


@dataclass
class OffloadMergeRequest:
    job_id: int = 0


@dataclass
class OffloadMergeResponse:
    error: int = 0
    error_text: str = ""
    outputs: List[LearnBlockEntry] = field(default_factory=list)
    stats_json: str = ""
    # trailing: the service-side hop records for the job (JSON list)
    spans_json: str = ""


@dataclass
class OffloadFetchRequest:
    """One bounded chunk of a merged output block (response:
    LearnFetchResponse)."""

    job_id: int = 0
    name: str = ""
    offset: int = 0
    length: int = 0


@dataclass
class OffloadFinishRequest:
    """Release the job (staged runs stay content-addressed for reuse;
    the job dir and its outputs drop)."""

    job_id: int = 0


def match_filter(filter_type: int, pattern: bytes, data: bytes) -> bool:
    """The anywhere/prefix/postfix matcher shared by scans and multi_get."""
    if filter_type == FilterType.NO_FILTER or not pattern:
        return True
    if len(data) < len(pattern):
        return False
    if filter_type == FilterType.MATCH_ANYWHERE:
        return pattern in data
    if filter_type == FilterType.MATCH_PREFIX:
        return data.startswith(pattern)
    if filter_type == FilterType.MATCH_POSTFIX:
        return data.endswith(pattern)
    raise ValueError(f"bad filter type {filter_type}")

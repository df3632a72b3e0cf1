"""Wire message types of the compaction-offload plane.

Port of the subset of pegasus_tpu/rpc/messages.py that the offload
service and its client speak. Field names, types, defaults and ORDER
are those of the JAX package, trailing fields included: the codec
(rpc/codec.py) writes fields by position, so a field moved, inserted or
retyped still round-trips inside one package but breaks against the
other.

A tenant ships packed runs (content-addressed, chunked, CRC-checked),
the service merges them on its device and the tenant fetches the merged
output back. Block identity is a LearnBlockEntry (name + size + content
digest); chunk fetches answer with a LearnFetchResponse (data + crc +
total).
"""

from dataclasses import dataclass, field
from typing import List


@dataclass
class LearnBlockEntry:
    """One block in a manifest: filename + size + content digest."""

    name: str = ""
    size: int = 0
    digest: str = ""


@dataclass
class LearnFetchResponse:
    error: int = 0
    error_text: str = ""
    data: bytes = b""
    crc: int = 0               # crc32 of `data` (per-chunk integrity)
    total: int = 0             # whole-block size


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
    # trailing: the tenant's job-trace id (the port sends "")
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

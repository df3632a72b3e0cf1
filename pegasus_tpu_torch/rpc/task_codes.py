"""rrdb task-code names (src/include/rrdb/rrdb.code.definition.h:25-40).

The port's copy of pegasus_tpu/rpc/task_codes.py: the codes are strings
on the wire (RpcHeader.code), so both packages must spell them alike.
One home for the server dispatcher, the serverlet and the client; the
write codes carry batching semantics (BATCHABLE) the dispatcher uses like
the reference's ALLOW_BATCH task-spec flag.
"""

RPC_PUT = "RPC_RRDB_RRDB_PUT"
RPC_MULTI_PUT = "RPC_RRDB_RRDB_MULTI_PUT"
RPC_REMOVE = "RPC_RRDB_RRDB_REMOVE"
RPC_MULTI_REMOVE = "RPC_RRDB_RRDB_MULTI_REMOVE"
RPC_INCR = "RPC_RRDB_RRDB_INCR"
RPC_CHECK_AND_SET = "RPC_RRDB_RRDB_CHECK_AND_SET"
RPC_CHECK_AND_MUTATE = "RPC_RRDB_RRDB_CHECK_AND_MUTATE"
RPC_DUPLICATE = "RPC_RRDB_RRDB_DUPLICATE"
RPC_BULK_LOAD_INGEST = "RPC_RRDB_RRDB_BULK_LOAD"
# admin no-op mutation: rides the PacificA prepare path so every replica
# computes a consistency digest at the SAME applied decree
RPC_TRIGGER_AUDIT = "RPC_RRDB_RRDB_TRIGGER_AUDIT"

RPC_GET = "RPC_RRDB_RRDB_GET"
RPC_MULTI_GET = "RPC_RRDB_RRDB_MULTI_GET"
RPC_SORTKEY_COUNT = "RPC_RRDB_RRDB_SORTKEY_COUNT"
RPC_TTL = "RPC_RRDB_RRDB_TTL"
RPC_GET_SCANNER = "RPC_RRDB_RRDB_GET_SCANNER"
RPC_SCAN = "RPC_RRDB_RRDB_SCAN"
RPC_CLEAR_SCANNER = "RPC_RRDB_RRDB_CLEAR_SCANNER"

BATCHABLE = {RPC_PUT, RPC_REMOVE}

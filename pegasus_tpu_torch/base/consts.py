"""Table app-env key names and scan sentinels.

The port's copy of pegasus_tpu/base/consts.py: the same strings, since a
meta server of either package spreads these envs to replicas of either.
App-envs are the per-table dynamic control surface, hot-applied by
PegasusServer.update_app_envs.
"""

SCAN_CONTEXT_ID_VALID_MIN = 0
SCAN_CONTEXT_ID_COMPLETED = -1
SCAN_CONTEXT_ID_NOT_EXIST = -2

ENV_USAGE_SCENARIO_KEY = "rocksdb.usage_scenario"
USAGE_SCENARIO_NORMAL = "normal"
USAGE_SCENARIO_PREFER_WRITE = "prefer_write"
USAGE_SCENARIO_BULK_LOAD = "bulk_load"

MANUAL_COMPACT_KEY_PREFIX = "manual_compact."
MANUAL_COMPACT_DISABLED_KEY = MANUAL_COMPACT_KEY_PREFIX + "disabled"
MANUAL_COMPACT_MAX_CONCURRENT_RUNNING_COUNT_KEY = (
    MANUAL_COMPACT_KEY_PREFIX + "max_concurrent_running_count"
)
MANUAL_COMPACT_PERIODIC_KEY_PREFIX = MANUAL_COMPACT_KEY_PREFIX + "periodic."
MANUAL_COMPACT_PERIODIC_TRIGGER_TIME_KEY = (
    MANUAL_COMPACT_PERIODIC_KEY_PREFIX + "trigger_time")
MANUAL_COMPACT_ONCE_KEY_PREFIX = MANUAL_COMPACT_KEY_PREFIX + "once."
MANUAL_COMPACT_ONCE_TRIGGER_TIME_KEY = (
    MANUAL_COMPACT_ONCE_KEY_PREFIX + "trigger_time")

MANUAL_COMPACT_TARGET_LEVEL_KEY = "target_level"
MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_KEY = "bottommost_level_compaction"
MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_FORCE = "force"
MANUAL_COMPACT_BOTTOMMOST_LEVEL_COMPACTION_SKIP = "skip"

# engine-selection env: "cpu" or "cuda" ("tpu", which a pegasus_tpu meta
# may spread, selects the device backend too)
COMPACTION_BACKEND_KEY = "compaction_backend"

TABLE_LEVEL_DEFAULT_TTL = "default_ttl"

CHECKPOINT_RESERVE_MIN_COUNT = "rocksdb.checkpoint.reserve_min_count"
CHECKPOINT_RESERVE_TIME_SECONDS = "rocksdb.checkpoint.reserve_time_seconds"

ENV_SLOW_QUERY_THRESHOLD = "replica.slow_query_threshold"
ITERATION_THRESHOLD_TIME_MS = "replica.rocksdb_iteration_threshold_time_ms"
USER_SPECIFIED_COMPACTION = "user_specified_compaction"

# partition-split ownership mask, spread post-split so compaction GCs keys
# the partition no longer owns
REPLICA_PARTITION_VERSION = "replica.partition_version"

# per-table SST compression (the rocksdb compression_type knob)
ROCKSDB_COMPRESSION_TYPE = "rocksdb.compression_type"

# range-read limiter thresholds
ROCKSDB_ITERATION_THRESHOLD_COUNT = "replica.rocksdb_max_iteration_count"
ROCKSDB_ITERATION_THRESHOLD_SIZE = "replica.rocksdb_max_iteration_size"
ROCKSDB_ITERATION_THRESHOLD_TIME_MS = ITERATION_THRESHOLD_TIME_MS

# duplication config travels to replicas as a reserved app-env (the meta
# pushes it with the normal env spread; replicas reconcile duplicators)
ENV_DUPLICATION_KEY = "__duplication__"

# per-table throttles and abnormal-size read tracing thresholds
# (hot-applied app-envs; 0 = disabled)
ENV_READ_THROTTLING = "replica.read_throttling"
ENV_WRITE_THROTTLING = "replica.write_throttling"
ENV_WRITE_THROTTLING_BY_SIZE = "replica.write_throttling_by_size"
ENV_ABNORMAL_GET_SIZE = "replica.abnormal_get_size_threshold"
ENV_ABNORMAL_MULTI_GET_SIZE = "replica.abnormal_multi_get_size_threshold"
ENV_ABNORMAL_MULTI_GET_ITERATE_COUNT = \
    "replica.abnormal_multi_get_iterate_count_threshold"

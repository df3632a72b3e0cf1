"""Table app-env key names the engine slice reads."""

# engine-selection env: "cpu" or "cuda"
COMPACTION_BACKEND_KEY = "compaction_backend"

TABLE_LEVEL_DEFAULT_TTL = "default_ttl"

# per-table SST compression (the rocksdb compression_type knob)
ROCKSDB_COMPRESSION_TYPE = "rocksdb.compression_type"

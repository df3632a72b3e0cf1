"""The LSM engine: KVBlock, memtable, SST format, LsmEngine (engine.db)."""

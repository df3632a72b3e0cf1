from .compact import CompactOptions, compact_blocks, sort_block

__all__ = ["CompactOptions", "compact_blocks", "sort_block"]

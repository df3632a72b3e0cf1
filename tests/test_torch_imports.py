"""The port's standing rules, checked on the source and on its entry points.

- No module of pegasus_tpu_torch, and not chip_smoke.py, imports jax or
  anything of pegasus_tpu (an AST walk over every import statement).
- An entry point with no device argument resolves to CUDA: on a machine
  without a card it raises instead of running on the CPU.
"""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pegasus_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith(".py")]
    return [os.path.relpath(p, ROOT) for p in out]


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    pkg_parts = os.path.dirname(path).split(os.sep)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: resolve against the file's package
                base = pkg_parts[: len(pkg_parts) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


@pytest.mark.parametrize("path", _sources())
def test_no_jax_or_reference_imports(path):
    for name in _imported_roots(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "pegasus_tpu"), \
            f"{path} imports {name}"


def test_source_walk_covers_the_package():
    paths = _sources()
    for mod in ("engine/db.py", "ops/compact.py", "ops/merge_path.py",
                "ops/device_lookup.py", "carry.py", "runtime/tracing.py",
                "engine/compaction_rules.py", "ops/pipeline.py",
                "ops/batched_compact.py", "ops/packing.py",
                "runtime/perf_counters.py", "runtime/events.py",
                "rpc/codec.py", "rpc/messages.py", "rpc/transport.py",
                "runtime/remote_command.py", "replication/learn.py",
                "parallel/sharded_compact.py",
                "replication/compact_offload.py", "runtime/config.py",
                "runtime/service_app.py", "server/__main__.py",
                "base/value_schema.py", "base/consts.py", "base/utils.py",
                "rpc/task_codes.py", "engine/scan_context.py",
                "engine/range_read_limiter.py", "engine/throttling.py",
                "engine/hotkey_collector.py",
                "engine/capacity_unit_calculator.py",
                "engine/write_service.py", "engine/bulk_load.py",
                "ops/device_watchdog.py",
                "engine/manual_compact_service.py",
                "engine/server_impl.py", "engine/replica_service.py",
                "client/client.py", "client/__init__.py",
                "ops/fence_lookup.py", "meta/messages.py",
                "meta/election.py", "meta/meta_server.py",
                "replication/replica_stub.py", "client/meta_resolver.py",
                "client/factory.py", "runtime/lockrank.py",
                "runtime/tasking.py", "runtime/job_trace.py",
                "runtime/table_stats.py", "runtime/metric_history.py",
                "runtime/toollets.py", "collector/__init__.py",
                "collector/cluster_doctor.py",
                "collector/compact_scheduler.py",
                "collector/info_collector.py",
                "collector/available_detector.py",
                "collector/reporter.py", "collector/auto_heal.py",
                "collector/flight_recorder.py", "geo/__init__.py",
                "geo/cells.py", "geo/geo_client.py", "geo/latlng_codec.py",
                "redis_proxy/__init__.py", "redis_proxy/proxy.py"):
        assert os.path.join("pegasus_tpu_torch", mod) in paths


def test_default_device_is_cuda():
    from pegasus_tpu_torch.engine.db import EngineOptions
    from pegasus_tpu_torch.ops.compact import CompactOptions, resolve_device

    assert EngineOptions().backend == "cuda"
    assert CompactOptions().backend == "cuda"
    assert resolve_device(EngineOptions().device) == torch.device("cuda")
    assert resolve_device(CompactOptions().device) == torch.device("cuda")


def test_default_entry_point_raises_without_a_card(tmp_path):
    """No silent CPU fallback: with no device argument the engine's
    device lane targets CUDA, and without a card that is an error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path runs there")
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.engine.block import KVBlock
    from pegasus_tpu_torch.engine.db import LsmEngine
    from pegasus_tpu_torch.ops.compact import compact_blocks, CompactOptions

    blk = KVBlock.from_records([(generate_key(b"h", b"%d" % i), b"v", 0,
                                 False) for i in range(5)])
    with pytest.raises((RuntimeError, AssertionError)):
        compact_blocks([blk], CompactOptions(now=1))
    eng = LsmEngine(str(tmp_path / "db"))
    eng.put(generate_key(b"h", b"s"), b"v")
    with pytest.raises((RuntimeError, AssertionError)):
        eng.flush()
    assert np.all(blk.key_len == 4)

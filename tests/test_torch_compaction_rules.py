"""The port's user-specified compaction rules
(pegasus_tpu_torch.engine.compaction_rules) against the JAX package's,
byte for byte.

The cases of tests/test_compaction_rules.py (parse skips, the pattern
matrix, TTL ranges, all rules of an op must match, the update-TTL
variants, tombstone and headerless skips, first match wins) run through
both packages' parsers and apply_operations on the same blocks: the drop
masks, the changed flags and every column of the rewritten blocks must
be equal. Then the rules inside compact_blocks on both port backends
against both reference backends, and a port engine's manual_compact with
user_ops against the reference engine's state_digest.
"""

import json

import numpy as np
import pytest

from pegasus_tpu.base.key_schema import generate_key as ref_generate_key
from pegasus_tpu.base.value_schema import SCHEMAS
from pegasus_tpu.engine import compaction_rules as ref_rules
from pegasus_tpu.engine.db import EngineOptions as RefEngineOptions
from pegasus_tpu.engine.db import LsmEngine as RefEngine
from pegasus_tpu.ops import compact as ref_compact
from pegasus_tpu.ops.compact import CompactOptions as RefOptions
from pegasus_tpu_torch.engine import compaction_rules as port_rules
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine
from pegasus_tpu_torch.ops import compact as port_compact
from pegasus_tpu_torch.ops.compact import CompactOptions
from tests.test_compact_ops import make_block
from tests.test_torch_compact import assert_same, to_port


def spec(*ops):
    return json.dumps({"ops": list(ops)})


def op(type_, params=None, rules=()):
    return {"type": type_, "params": json.dumps(params or {}),
            "rules": [{"type": t, "params": json.dumps(p)} for t, p in rules]}


def both_apply(records, spec_json, now):
    """apply_operations of both packages on copies of one block: drop
    masks and changed flags equal, rewritten blocks byte-equal. -> the
    port's (drop, changed, block)."""
    ref_blk = make_block(records)
    port_blk = to_port(ref_blk)
    ref_drop, ref_changed = ref_rules.apply_operations(
        ref_blk, ref_rules.parse_user_specified_compaction(spec_json), now)
    drop, changed = port_rules.apply_operations(
        port_blk, port_rules.parse_user_specified_compaction(spec_json), now)
    np.testing.assert_array_equal(ref_drop, drop)
    assert ref_changed == changed
    assert_same(ref_blk, port_blk)
    return drop, changed, port_blk


def test_parse_skips_invalid_entries():
    for parse in (ref_rules.parse_user_specified_compaction,
                  port_rules.parse_user_specified_compaction):
        assert parse("not json") == []
        assert parse(spec(op("COT_DELETE", rules=[]))) == []
        ops = parse(spec(
            op("COT_DELETE", rules=[("FRT_BOGUS", {})]),
            op("COT_DELETE",
               rules=[("FRT_HASHKEY_PATTERN",
                       {"pattern": "x", "match_type": "SMT_MATCH_PREFIX"})]),
            op("COT_UPDATE_TTL", {"value": 3},
               rules=[("FRT_TTL_RANGE", {"start_ttl": 0, "stop_ttl": 0})])))
        assert [type(o).__name__ for o in ops] == ["DeleteKeyOp"]


@pytest.mark.parametrize("match_type,pattern,hk,expect", [
    ("SMT_MATCH_PREFIX", "user", b"user123", True),
    ("SMT_MATCH_PREFIX", "user", b"xuser", False),
    ("SMT_MATCH_POSTFIX", "123", b"user123", True),
    ("SMT_MATCH_POSTFIX", "123", b"123x", False),
    ("SMT_MATCH_ANYWHERE", "er1", b"user123", True),
    ("SMT_MATCH_ANYWHERE", "zzz", b"user123", False),
    ("SMT_MATCH_PREFIX", "toolongpattern", b"user", False),
    ("SMT_MATCH_PREFIX", "", b"user", False),
])
def test_hashkey_pattern_matrix(match_type, pattern, hk, expect):
    drop, _, _ = both_apply(
        [(hk, b"s", b"v", 0, False), (b"other", b"s", b"v", 0, False)],
        spec(op("COT_DELETE", rules=[("FRT_HASHKEY_PATTERN",
                                      {"pattern": pattern,
                                       "match_type": match_type})])), 100)
    assert bool(drop[0]) is expect


@pytest.mark.parametrize("match_type", ["SMT_MATCH_PREFIX",
                                        "SMT_MATCH_POSTFIX",
                                        "SMT_MATCH_ANYWHERE"])
def test_sortkey_pattern_rule(match_type):
    drop, _, _ = both_apply(
        [(b"h", b"abc_keep", b"v", 0, False),
         (b"h", b"drop_abc", b"v", 0, False),
         (b"h", b"", b"v", 0, False),
         (b"h", b"x_drop", b"v", 0, False)],
        spec(op("COT_DELETE", rules=[("FRT_SORTKEY_PATTERN",
                                      {"pattern": "drop",
                                       "match_type": match_type})])), 100)
    assert drop[1] == (match_type != "SMT_MATCH_POSTFIX")
    assert not drop[0] and not drop[2]


@pytest.mark.parametrize("start,stop,expect", [
    (0, 0, [True, False, False]),      # 0/0: records without a TTL
    (10, 100, [False, True, False]),
    (0, 1000, [False, True, True]),
])
def test_ttl_range_rule_matrix(start, stop, expect):
    now = 1000
    drop, _, _ = both_apply(
        [(b"h", b"nottl", b"v", 0, False),
         (b"h", b"in", b"v", now + 50, False),
         (b"h", b"out", b"v", now + 500, False)],
        spec(op("COT_DELETE", rules=[("FRT_TTL_RANGE",
                                      {"start_ttl": start,
                                       "stop_ttl": stop})])), now)
    assert list(drop) == expect


def test_all_rules_must_match():
    drop, _, _ = both_apply(
        [(b"user1", b"tmp_x", b"v", 0, False),
         (b"user1", b"keep", b"v", 0, False),
         (b"other", b"tmp_y", b"v", 0, False)],
        spec(op("COT_DELETE", rules=[
            ("FRT_HASHKEY_PATTERN",
             {"pattern": "user", "match_type": "SMT_MATCH_PREFIX"}),
            ("FRT_SORTKEY_PATTERN",
             {"pattern": "tmp_", "match_type": "SMT_MATCH_PREFIX"})])), 100)
    assert list(drop) == [True, False, False]


@pytest.mark.parametrize("ttl_type,value,want", [
    ("UTOT_FROM_NOW", 77, [1077, 1077]),
    ("UTOT_FROM_CURRENT", 5, [0, 1105]),
    ("UTOT_TIMESTAMP", 1451606400 + 5000, [5000, 5000]),
])
def test_update_ttl_variants(ttl_type, value, want):
    now = 1000
    _, changed, blk = both_apply(
        [(b"h", b"a", b"v", 0, False), (b"h", b"b", b"v", now + 100, False)],
        spec(op("COT_UPDATE_TTL", {"type": ttl_type, "value": value},
                [("FRT_HASHKEY_PATTERN",
                  {"pattern": "h", "match_type": "SMT_MATCH_PREFIX"})])), now)
    assert changed and list(blk.expire_ts) == want
    assert [SCHEMAS[2].extract_expire_ts(blk.value(i))
            for i in range(2)] == want


@pytest.mark.parametrize("dead_first", [True, False])
def test_update_ttl_skips_tombstones_and_headerless(dead_first):
    """A tombstone matches TTL 0/0 (its expire is 0) but is never offered
    to a rule; a value shorter than its expire field keeps its bytes; the
    live record's header is rewritten in the column and the bytes."""
    recs = [(b"h", b"a_dead", b"", 0, True),
            (b"h", b"b_live", b"payload", 0, False)]
    if not dead_first:
        recs = recs[::-1]
    _, changed, blk = both_apply(
        recs, spec(op("COT_UPDATE_TTL", {"type": "UTOT_FROM_NOW", "value": 9},
                      [("FRT_TTL_RANGE", {"start_ttl": 0, "stop_ttl": 0})])),
        500)
    live = 1 if dead_first else 0
    assert changed and blk.expire_ts[live] == 509
    assert blk.expire_ts[1 - live] == 0 and blk.val_len[1 - live] == 0
    assert SCHEMAS[2].extract_user_data(blk.value(live)) == b"payload"


def test_update_ttl_skips_values_shorter_than_the_field():
    from pegasus_tpu.engine.block import KVBlock as RefBlock

    # a raw 3-byte value cannot hold the 4-byte expire field
    rows = [(ref_generate_key(b"h", b"a"), b"\x01\x02\x03", 0, False),
            (ref_generate_key(b"h", b"b"),
             SCHEMAS[2].generate_value(0, 0, b"x"), 0, False)]
    ref_blk = RefBlock.from_records(rows)
    port_blk = to_port(ref_blk)
    text = spec(op("COT_UPDATE_TTL", {"type": "UTOT_FROM_NOW", "value": 9},
                   [("FRT_HASHKEY_PATTERN",
                     {"pattern": "h", "match_type": "SMT_MATCH_PREFIX"})]))
    ref_rules.apply_operations(
        ref_blk, ref_rules.parse_user_specified_compaction(text), 10)
    port_rules.apply_operations(
        port_blk, port_rules.parse_user_specified_compaction(text), 10)
    assert_same(ref_blk, port_blk)
    assert port_blk.value(0) == b"\x01\x02\x03"


def test_first_matching_op_wins():
    rules = [("FRT_HASHKEY_PATTERN",
              {"pattern": "h", "match_type": "SMT_MATCH_PREFIX"})]
    drop, changed, blk = both_apply(
        [(b"h", b"s", b"v", 0, False), (b"g", b"s", b"v", 0, False)],
        spec(op("COT_UPDATE_TTL", {"type": "UTOT_FROM_NOW", "value": 9},
                rules),
             op("COT_DELETE", rules=rules),
             op("COT_DELETE", rules=[("FRT_SORTKEY_PATTERN",
                                      {"pattern": "s",
                                       "match_type": "SMT_MATCH_PREFIX"})])),
        100)
    assert list(drop) == [False, True] and changed
    assert blk.expire_ts[0] == 109


def _rule_runs(seed):
    rng = np.random.default_rng(seed)
    runs = []
    for r in range(3):
        recs = []
        for i in range(150):
            hk = (b"tmp_%d" if rng.random() < 0.3 else b"keep_%d") % \
                rng.integers(0, 80)
            deleted = bool(rng.random() < 0.1)
            recs.append((hk, b"s%d" % (i % 7), b"" if deleted else
                         b"r%dv%d" % (r, i), int(rng.integers(0, 3)) * 60,
                         deleted))
        runs.append(ref_compact.sort_block(make_block(recs),
                                           RefOptions(backend="cpu")))
    return runs


RULES_SPEC = spec(
    op("COT_DELETE", rules=[("FRT_HASHKEY_PATTERN",
                             {"pattern": "tmp_",
                              "match_type": "SMT_MATCH_PREFIX"})]),
    op("COT_UPDATE_TTL", {"type": "UTOT_FROM_NOW", "value": 500},
       [("FRT_SORTKEY_PATTERN", {"pattern": "3",
                                 "match_type": "SMT_MATCH_POSTFIX"})]),
    op("COT_DELETE", rules=[("FRT_TTL_RANGE",
                             {"start_ttl": 0, "stop_ttl": 30})]))


@pytest.mark.parametrize("default_ttl", [0, 40])
@pytest.mark.parametrize("runs_sorted", [True, None])
def test_rules_in_compaction_match_reference(default_ttl, runs_sorted):
    """compact_blocks with user_ops: the port's cuda (plain merge on the
    CPU) and cpu backends against the reference's tpu and cpu backends,
    with and without a default_ttl rewrite after the rules."""
    runs = _rule_runs(5)
    kw = dict(now=100, bottommost=True, default_ttl=default_ttl,
              runs_sorted=runs_sorted)
    ref_ops = tuple(ref_rules.parse_user_specified_compaction(RULES_SPEC))
    port_ops = tuple(port_rules.parse_user_specified_compaction(RULES_SPEC))
    want = ref_compact.compact_blocks(runs, RefOptions(
        backend="cpu", user_ops=ref_ops, **kw))
    tpu = ref_compact.compact_blocks(runs, RefOptions(
        backend="tpu", user_ops=ref_ops, **kw))
    assert_same(want.block, tpu.block)
    port_runs = [to_port(b) for b in runs]
    for backend in ("cuda", "cpu"):
        got = port_compact.compact_blocks(port_runs, CompactOptions(
            backend=backend, device="cpu", user_ops=port_ops, **kw))
        assert_same(want.block, got.block)
        assert got.stats == want.stats
    keys = [want.block.key(i) for i in range(want.block.n)]
    assert keys and not any(k[2:].startswith(b"tmp_") for k in keys)


def _fill(eng, generate_key):
    rng = np.random.default_rng(9)
    for i in range(600):
        hk = (b"tmp_%d" if i % 4 == 0 else b"user%d") % rng.integers(0, 90)
        eng.put(generate_key(hk, b"s%d" % (i % 11)),
                SCHEMAS[2].generate_value(int(rng.integers(0, 3)) * 70, 0,
                                          b"v%d" % i),
                int(rng.integers(0, 3)) * 70)
        if i % 150 == 149:
            eng.flush()
        if i % 37 == 0:
            eng.delete(generate_key(b"user%d" % rng.integers(0, 90), b"s1"))


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_engine_manual_compact_with_user_ops_matches_reference(tmp_path,
                                                               backend):
    ref = RefEngine(str(tmp_path / "ref"), RefEngineOptions(
        backend="cpu", user_ops=tuple(
            ref_rules.parse_user_specified_compaction(RULES_SPEC))))
    port = LsmEngine(str(tmp_path / "port"), EngineOptions(
        backend=backend, device="cpu", user_ops=tuple(
            port_rules.parse_user_specified_compaction(RULES_SPEC))))
    from pegasus_tpu_torch.base.key_schema import generate_key

    _fill(ref, ref_generate_key)
    _fill(port, generate_key)
    ref.manual_compact(now=100)
    port.manual_compact(now=100)
    try:
        assert port.state_digest(now=100) == ref.state_digest(now=100)
        got = list(port.scan(now=100))
        assert got == list(ref.scan(now=100))
        assert got and not any(k[2:].startswith(b"tmp_") for k, _, _ in got)
    finally:
        ref.close()
        port.close()

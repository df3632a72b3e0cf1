"""User-specified compaction rules as vectorised batch predicates.

Port of pegasus_tpu/engine/compaction_rules.py (the reference's
compaction_filter_rule + compaction_operation; RFC
rfcs/2021-05-27-user-specified-compaction.md). The
`user_specified_compaction` app-env carries JSON

    {"ops": [{"type": "COT_DELETE"|"COT_UPDATE_TTL",
              "params": <op json>,
              "rules": [{"type": "FRT_HASHKEY_PATTERN"|"FRT_SORTKEY_PATTERN"
                                |"FRT_TTL_RANGE",
                         "params": <rule json>}]}]}

An operation compiles into column masks over a whole KVBlock: pattern
rules as 2-D numpy window compares over the padded hash/sort key
matrices, TTL ranges as compares on the expire column. Operations apply
in order and the first one whose rules all match handles a record.
Tombstones are never offered to a rule; an expire rewrite skips values
too short to hold the 4-byte expire field.

Host-side numpy, as in the reference: the rules run after the device
merge, on the survivors (ops/compact.py apply_post_filters).
"""

import json

import numpy as np

from ..base.utils import epoch_begin

SMT_ANYWHERE = "SMT_MATCH_ANYWHERE"
SMT_PREFIX = "SMT_MATCH_PREFIX"
SMT_POSTFIX = "SMT_MATCH_POSTFIX"

UTOT_FROM_NOW = "UTOT_FROM_NOW"
UTOT_FROM_CURRENT = "UTOT_FROM_CURRENT"
UTOT_TIMESTAMP = "UTOT_TIMESTAMP"


def _key_parts_matrix(block):
    """-> (hk uint8[n, max_hk], hk_len[n], sk uint8[n, max_sk], sk_len[n]):
    every record's hash_key and sort_key, zero-padded to a matrix."""
    n = block.n
    off = block.key_off
    arena = block.key_arena
    hk_len = (arena[off].astype(np.int64) << 8) | arena[off + 1]
    sk_len = block.key_len.astype(np.int64) - 2 - hk_len
    max_hk = int(hk_len.max()) if n else 0
    max_sk = int(sk_len.max()) if n else 0

    def gather(base_off, lens, width):
        if width == 0:
            return np.zeros((n, 0), np.uint8)
        pos = np.arange(width, dtype=np.int64)
        idx = base_off[:, None] + pos[None, :]
        valid = pos[None, :] < lens[:, None]
        return np.where(valid, arena[np.minimum(idx, len(arena) - 1)], 0)

    hk = gather(off + 2, hk_len, max_hk)
    sk = gather(off + 2 + hk_len, sk_len, max_sk)
    return hk, hk_len, sk, sk_len


def _pattern_mask(matrix, lens, pattern: bytes, match_type: str) -> np.ndarray:
    n = matrix.shape[0]
    plen = len(pattern)
    if plen == 0 or plen > matrix.shape[1]:
        return np.zeros(n, dtype=bool)
    pat = np.frombuffer(pattern, dtype=np.uint8)
    fits = lens >= plen
    if match_type == SMT_PREFIX:
        return fits & (matrix[:, :plen] == pat).all(axis=1)
    if match_type == SMT_POSTFIX:
        starts = np.maximum(lens - plen, 0)
        idx = np.minimum(starts[:, None] + np.arange(plen)[None, :],
                         matrix.shape[1] - 1)
        tail = np.take_along_axis(matrix, idx, axis=1)
        return fits & (tail == pat).all(axis=1)
    if match_type == SMT_ANYWHERE:
        out = np.zeros(n, dtype=bool)
        for s in range(0, matrix.shape[1] - plen + 1):
            out |= (lens >= s + plen) & (matrix[:, s: s + plen] == pat).all(
                axis=1)
        return out
    raise ValueError(f"bad match type {match_type}")


def _pattern_bytes(params: dict) -> bytes:
    p = params["pattern"]
    return p.encode() if isinstance(p, str) else p


class Rule:
    def match_mask(self, ctx) -> np.ndarray:
        raise NotImplementedError


class HashkeyPatternRule(Rule):
    def __init__(self, params: dict):
        self.pattern = _pattern_bytes(params)
        self.match_type = params["match_type"]

    def match_mask(self, ctx):
        hk, hk_len, _, _ = ctx["parts"]
        return _pattern_mask(hk, hk_len, self.pattern, self.match_type)


class SortkeyPatternRule(Rule):
    def __init__(self, params: dict):
        self.pattern = _pattern_bytes(params)
        self.match_type = params["match_type"]

    def match_mask(self, ctx):
        _, _, sk, sk_len = ctx["parts"]
        return _pattern_mask(sk, sk_len, self.pattern, self.match_type)


class TtlRangeRule(Rule):
    """start/stop 0/0 matches records without a TTL; otherwise the
    remaining TTL must lie in [start_ttl, stop_ttl]."""

    def __init__(self, params: dict):
        self.start_ttl = int(params.get("start_ttl", 0))
        self.stop_ttl = int(params.get("stop_ttl", 0))

    def match_mask(self, ctx):
        expire = ctx["block"].expire_ts.astype(np.int64)
        now = ctx["now"]
        if self.start_ttl == 0 and self.stop_ttl == 0:
            return expire == 0
        return ((self.start_ttl + now <= expire)
                & (self.stop_ttl + now >= expire))


class Operation:
    def __init__(self, rules):
        self.rules = rules

    def all_rules_match(self, ctx) -> np.ndarray:
        mask = np.ones(ctx["block"].n, dtype=bool)
        for r in self.rules:
            mask &= r.match_mask(ctx)
        return mask


class DeleteKeyOp(Operation):
    pass


class UpdateTtlOp(Operation):
    def __init__(self, rules, params: dict):
        super().__init__(rules)
        self.type = params["type"]
        self.value = int(params.get("value", 0))

    def new_expire(self, ctx, mask):
        """-> (new expire column uint32[n], the rows it changes)."""
        now = ctx["now"]
        expire = ctx["block"].expire_ts.astype(np.int64)
        if self.type == UTOT_FROM_NOW:
            ne = np.full(len(expire), now + self.value, np.int64)
        elif self.type == UTOT_FROM_CURRENT:
            ne = np.where(expire > 0, expire + self.value, 0)
            mask = mask & (expire > 0)  # records without a TTL keep none
        elif self.type == UTOT_TIMESTAMP:
            # value is a unix timestamp; expire_ts counts from 2016
            ne = np.full(len(expire), self.value - epoch_begin, np.int64)
        else:
            raise ValueError(f"bad update_ttl type {self.type}")
        return np.where(mask, ne, expire).astype(np.uint32), mask


_RULE_TYPES = {
    "FRT_HASHKEY_PATTERN": HashkeyPatternRule,
    "FRT_SORTKEY_PATTERN": SortkeyPatternRule,
    "FRT_TTL_RANGE": TtlRangeRule,
}


def parse_user_specified_compaction(spec: str):
    """The app-env's JSON -> list of Operations. Invalid entries are
    skipped (an unknown rule type, bad params, an op left without rules),
    as the reference logs and continues; a value that is not JSON parses
    to no operations."""
    try:
        doc = json.loads(spec)
    except (ValueError, TypeError):
        return []
    ops = []
    for op in doc.get("ops", []):
        rules = []
        for r in op.get("rules", []):
            cls = _RULE_TYPES.get(r.get("type"))
            if cls is None:
                continue
            params = r.get("params", {})
            if isinstance(params, str):
                params = json.loads(params)
            try:
                rules.append(cls(params))
            except (KeyError, ValueError):
                continue
        if not rules:
            continue
        params = op.get("params", {})
        if isinstance(params, str):
            params = json.loads(params) if params else {}
        if op.get("type") == "COT_DELETE":
            ops.append(DeleteKeyOp(rules))
        elif op.get("type") == "COT_UPDATE_TTL":
            try:
                ops.append(UpdateTtlOp(rules, params))
            except (KeyError, ValueError):
                continue
    return ops


def apply_operations(block, ops, now: int):
    """-> (drop mask bool[n], changed). The first op whose rules all match
    handles a record; an update-TTL op rewrites expire_ts and the value's
    expire field in place."""
    n = block.n
    drop = np.zeros(n, dtype=bool)
    if not ops or n == 0:
        return drop, False
    ctx = {"block": block, "now": now, "parts": _key_parts_matrix(block)}
    # tombstones are never offered to a rule (the compaction filter sees
    # values only)
    unhandled = ~np.asarray(block.deleted, dtype=bool)
    changed = False
    for op in ops:
        mask = op.all_rules_match(ctx) & unhandled
        if not mask.any():
            continue
        unhandled &= ~mask
        if isinstance(op, DeleteKeyOp):
            drop |= mask
        else:
            new_expire, eff = op.new_expire(ctx, mask)
            if eff.any():
                _rewrite_expire(block, new_expire, eff)
                changed = True
    return drop, changed


def _rewrite_expire(block, new_expire: np.ndarray, mask: np.ndarray) -> None:
    """Rewrite expire_ts in the column and in the value bytes (offset 0 in
    v0/v1 values, 1 in self-describing v2 ones), in place. A value too
    short for the field keeps its bytes: 4 bytes written there would land
    in the next record's value (or off the arena's end)."""
    idx = np.nonzero(mask)[0]
    block.expire_ts[idx] = new_expire[idx]
    idx = idx[block.val_len[idx] > 0]
    if len(idx) == 0:
        return
    off = block.val_off[idx]
    is_v2 = (block.val_arena[off] & 0x80) != 0
    fits = block.val_len[idx] >= np.where(is_v2, 5, 4)
    idx, off, is_v2 = idx[fits], off[fits], is_v2[fits]
    off = off + np.where(is_v2, 1, 0)
    vals = new_expire[idx]
    for j, shift in enumerate((24, 16, 8, 0)):
        block.val_arena[off + j] = ((vals >> shift) & 0xFF).astype(np.uint8)

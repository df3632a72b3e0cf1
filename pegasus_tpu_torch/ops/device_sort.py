"""Lexicographic compares and the plain two-run merge, on torch tensors.

Device layout of the port: every u32 sort column (key lanes, suffix rank,
klen, the klen<<8|prio tie column) and every payload column (the int32
survivor index) is held as int64, so torch's signed compares order the
lanes as the JAX package's unsigned u32 compares do, pads (0xFFFFFFFF)
included. The conversion happens once, where a run is packed onto the
device (ops/compact.py pack_run_device, prepare) or carried over from the
JAX package (carry.py).

A merge operand is one stacked int64 tensor [n_cols, L]: rows 0..nk-1
are the key columns, most significant first; the rest are payload. A
batched operand [B, n_cols, L] holds B independent operands.

merge_two_sorted_plain is the yardstick for the merge-path kernel
(ops/merge_path.py): independent of it, and what CPU tensors run.
"""

import torch


def lex_cmp(a_cols, b_cols):
    """(a < b, a == b) lexicographic over sequences of int64 columns,
    elementwise."""
    less = a_cols[0] < b_cols[0]
    eq = a_cols[0] == b_cols[0]
    for a, b in zip(a_cols[1:], b_cols[1:]):
        less = less | (eq & (a < b))
        eq = eq & (a == b)
    return less, eq


def lex_less(a_cols, b_cols):
    """Strict lexicographic a < b, elementwise."""
    return lex_cmp(a_cols, b_cols)[0]


def merge_two_sorted_plain(a: torch.Tensor, b: torch.Tensor,
                           nk: int) -> torch.Tensor:
    """Merge two [n_cols, L] operands, each ascending over rows 0..nk-1,
    into one [n_cols, la+lb] operand ascending over the same rows; with a
    leading batch axis ([B, n_cols, L]) each batch row merges on its own.

    Stable sort passes along the last dim from the least significant key
    row up (an LSD radix over whole columns): the result is the
    lexicographic order, and equal keys keep concat order, A's rows
    before B's."""
    if a.dim() == 2:
        return merge_two_sorted_plain(a[None], b[None], nk)[0]
    cat = torch.cat([a, b], dim=2)
    batch, n_cols, n = cat.shape
    perm = torch.arange(n, device=cat.device).expand(batch, -1)
    for c in range(nk - 1, -1, -1):
        order = torch.sort(torch.gather(cat[:, c], 1, perm), dim=1,
                           stable=True).indices
        perm = torch.gather(perm, 1, order)
    return torch.gather(cat, 2, perm[:, None].expand(-1, n_cols, -1))

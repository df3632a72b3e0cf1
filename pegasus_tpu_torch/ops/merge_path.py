"""The two-run merge of compaction: the hand-written merge-path CUDA kernels
(csrc/merge_path.cu) on CUDA tensors, the plain PyTorch merge on CPU
tensors.

Port of pegasus_tpu/ops/pallas_merge.py merge_two_sorted_pallas. One merge
is two launches: the partition pass finds the merge-path split of every
TILE-output boundary (merge_path_splits; the reference's
_diagonal_splits), then one block per tile merges its two input windows
in shared memory. Operands are [n_cols, L] for one merge or
[B, n_cols, L] for B independent merges in the same two launches (a grid
row per batch row: the batched multi-partition compaction's merge, where
the reference vmaps its XLA merge). The dispatch is on the tensors'
device only: a CUDA operand launches the kernels or raises (a build or
launch failure is never papered over with the plain merge); a CPU operand
takes merge_path_splits_plain and device_sort.merge_two_sorted_plain.

LAUNCHES["merge_path"] counts merges that went through the kernels, one
per merge_two_sorted call whatever its batch; LAUNCHES["merge_path_rows"]
adds each call's batch rows. A run proves it went through the kernels by
reading the counts before and after, and a batched run that B merges
shared each call by the ratio of the two. LAUNCHES["merge_path"] and
["merge_path_rows"] are exported as the perf counters
kernel.merge_path.launches and kernel.merge_path.rows, so a serving
process can be scraped for them.
"""

import ctypes
import threading

import torch

from ..runtime.perf_counters import counters
from .device_sort import lex_less, merge_two_sorted_plain

LAUNCHES = {"merge_path": 0, "merge_path_rows": 0}
counters.gauge("kernel.merge_path.launches", lambda: LAUNCHES["merge_path"])
counters.gauge("kernel.merge_path.rows", lambda: LAUNCHES["merge_path_rows"])
# merges of concurrent compactions (the offload service's RPC threads)
# count from several threads
_LAUNCHES_LOCK = threading.Lock()

TILE = 2048    # outputs per block of the merge kernel (kTile)
MAX_KEYS = 10  # key columns: 8 lanes + suffix rank + kp (kMaxKeys)
MAX_BATCH = 65535  # batch rows per launch (the grid's y extent)


def _check(a: torch.Tensor, b: torch.Tensor, nk: int) -> None:
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"merge operands must be int64, got {a.dtype}, "
                        f"{b.dtype}")
    if (a.dim() not in (2, 3) or a.dim() != b.dim()
            or a.shape[:-1] != b.shape[:-1]):
        raise ValueError(f"merge operands must be [n_cols, L] or "
                         f"[B, n_cols, L] with equal B and n_cols, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if not 1 <= nk <= a.shape[-2]:
        raise ValueError(f"nk={nk} outside 1..{a.shape[-2]}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def merge_two_sorted(a: torch.Tensor, b: torch.Tensor,
                     nk: int) -> torch.Tensor:
    """Merge [n_cols, la] and [n_cols, lb] int64 operands, each ascending
    lexicographically over rows 0..nk-1 (u32 values), into
    [n_cols, la+lb] ascending rows (ties: A first). With a leading batch
    axis ([B, n_cols, la] and [B, n_cols, lb]) batch row r of A merges
    with batch row r of B into [B, n_cols, la+lb], in the same launches."""
    _check(a, b, nk)
    if a.device.type != "cuda":
        return merge_two_sorted_plain(a, b, nk)
    if a.dim() == 2:
        return merge_two_sorted(a[None], b[None], nk)[0]
    a, b = a.contiguous(), b.contiguous()
    batch, n_cols, la = a.shape
    lb = b.shape[2]
    out = torch.empty((batch, n_cols, la + lb), dtype=torch.int64,
                      device=a.device)
    splits = _launch_splits(a, b, nk)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("merge_path_merge_i64")(
            a.data_ptr(), la, b.data_ptr(), lb, splits.data_ptr(),
            out.data_ptr(), n_cols, nk, batch, stream)
    if err != 0:
        raise RuntimeError(f"merge_path merge kernel launch failed: "
                           f"cudaError {err}")
    with _LAUNCHES_LOCK:
        LAUNCHES["merge_path"] += 1
        LAUNCHES["merge_path_rows"] += batch
    return out


def merge_path_splits(a: torch.Tensor, b: torch.Tensor,
                      nk: int) -> torch.Tensor:
    """int64 [ceil((la+lb)/TILE) + 1] ([B, ...] for batched operands):
    entry t is the number of A rows among the first min(t*TILE, la+lb)
    rows of the merge. The partition kernel on CUDA operands,
    merge_path_splits_plain on CPU ones."""
    _check(a, b, nk)
    if a.device.type != "cuda":
        return merge_path_splits_plain(a, b, nk)
    if a.dim() == 2:
        return _launch_splits(a[None].contiguous(), b[None].contiguous(),
                              nk)[0]
    return _launch_splits(a.contiguous(), b.contiguous(), nk)


def merge_path_splits_plain(a: torch.Tensor, b: torch.Tensor,
                            nk: int) -> torch.Tensor:
    """merge_path_splits as a vectorised binary search over the key
    columns, every tile boundary of every batch row at once, with the
    kernels' predicate: A's row precedes B's unless B's is strictly
    smaller."""
    if a.dim() == 2:
        return merge_path_splits_plain(a[None], b[None], nk)[0]
    batch, la, lb = a.shape[0], a.shape[2], b.shape[2]
    total = la + lb
    n_tiles = -(-total // TILE)
    d = torch.clamp(torch.arange(n_tiles + 1, device=a.device) * TILE,
                    max=total).expand(batch, -1)
    lo = torch.clamp(d - lb, min=0)
    hi = torch.clamp(d, max=la)
    if la == 0 or lb == 0:
        return lo.contiguous()
    for _ in range(la.bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        ia = torch.clamp(mid, max=la - 1)
        ib = torch.clamp(d - 1 - mid, 0, lb - 1)
        take_a = ~lex_less([torch.gather(b[:, c], 1, ib) for c in range(nk)],
                           [torch.gather(a[:, c], 1, ia) for c in range(nk)])
        lo = torch.where(active & take_a, mid + 1, lo)
        hi = torch.where(active & ~take_a, mid, hi)
    return lo


_ARGTYPES = {
    "merge_path_splits_i64": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p],
    "merge_path_merge_i64": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p],
}


def _entry(name: str):
    from ._build import load

    fn = getattr(load("merge_path"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch_splits(a: torch.Tensor, b: torch.Tensor,
                   nk: int) -> torch.Tensor:
    """The partition kernel on contiguous [B, n_cols, L] operands."""
    if nk > MAX_KEYS:
        raise ValueError(f"nk={nk} above the kernel's {MAX_KEYS} key columns")
    batch, n_cols, la = a.shape
    lb = b.shape[2]
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"batch={batch} outside the kernel's 1..{MAX_BATCH}")
    splits = torch.empty((batch, -(-(la + lb) // TILE) + 1),
                         dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("merge_path_splits_i64")(
            a.data_ptr(), la, b.data_ptr(), lb, n_cols, nk, batch,
            splits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"merge_path partition kernel launch failed: "
                           f"cudaError {err}")
    return splits

"""The two-run merge of compaction: the hand-written merge-path CUDA kernel
(csrc/merge_path.cu) on CUDA tensors, the plain PyTorch merge on CPU
tensors.

Port of pegasus_tpu/ops/pallas_merge.py merge_two_sorted_pallas. The
dispatch is on the tensors' device only: a CUDA operand launches the
kernel or raises (a build or launch failure is never papered over with
the plain merge); a CPU operand takes device_sort.merge_two_sorted_plain.

LAUNCHES counts kernel launches; a run proves it went through the kernel
by reading the count before and after.
"""

import ctypes

import torch

from .device_sort import merge_two_sorted_plain

LAUNCHES = {"merge_path": 0}


def _check(a: torch.Tensor, b: torch.Tensor, nk: int) -> None:
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"merge operands must be int64, got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"merge operands must be [n_cols, L] with equal "
                         f"n_cols, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not 1 <= nk <= a.shape[0]:
        raise ValueError(f"nk={nk} outside 1..{a.shape[0]}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def merge_two_sorted(a: torch.Tensor, b: torch.Tensor,
                     nk: int) -> torch.Tensor:
    """Merge [n_cols, la] and [n_cols, lb] int64 operands, each ascending
    lexicographically over rows 0..nk-1, into [n_cols, la+lb] ascending
    rows (ties: A first)."""
    _check(a, b, nk)
    if a.device.type != "cuda":
        return merge_two_sorted_plain(a, b, nk)
    return _launch(a.contiguous(), b.contiguous(), nk)


def _launch(a: torch.Tensor, b: torch.Tensor, nk: int) -> torch.Tensor:
    from ._build import load

    lib = load("merge_path")
    fn = lib.merge_two_sorted_i64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_cols, la = a.shape
    lb = b.shape[1]
    out = torch.empty((n_cols, la + lb), dtype=torch.int64, device=a.device)
    if la + lb == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), la, b.data_ptr(), lb, out.data_ptr(),
                 n_cols, nk, stream)
    if err != 0:
        raise RuntimeError(f"merge_path kernel launch failed: cudaError {err}")
    LAUNCHES["merge_path"] += 1
    return out

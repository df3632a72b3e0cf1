"""The fence lookup of device reads as one hand-written CUDA kernel
(csrc/fence_lookup.cu).

Port of the XLA program pegasus_tpu/ops/device_lookup.py
_fence_lower_bound (inside _compiled_lookup and _compiled_range): for
each query, two searchsorted probes of its first lane on the run's
fence, then a fixed-depth lexicographic lower_bound over the lanes and
the key length in the window they bound; for point lookups the equality
check that gives the row or -1, for ranges both bounds in the same
launch. One thread per query, the fence staged in shared memory.

device_lookup.fence_lookup calls `launch` for runs on the card and the
plain version (device_lookup.fence_lookup_plain) for runs on the CPU. A
build or launch failure raises. LAUNCHES["fence_lookup"] counts launches
and is exported as the perf counter kernel.fence_lookup.launches.
"""

import ctypes
import threading

import torch

from ..runtime.perf_counters import counters

LAUNCHES = {"fence_lookup": 0}
# probes run on the RPC workers of a serving process
_LAUNCHES_LOCK = threading.Lock()
counters.gauge("kernel.fence_lookup.launches",
               lambda: LAUNCHES["fence_lookup"])

MAX_LANES = 16     # kMaxLanes
MAX_FENCE = 4096   # kMaxFence: fence entries staged in shared memory

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def _entry():
    from ._build import load

    fn = load("fence_lookup").fence_lookup_i64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(dr, packed: torch.Tensor, steps: int) -> torch.Tensor:
    """The kernel on a resident run `dr` and the int64 [n_sets, w + 1, q]
    query buffer on the same card -> int32 [q] (one set: rows or -1) or
    [q, 2] (two sets: [lo, max(hi, lo)])."""
    n_sets, rows, nq = packed.shape
    cols, klen, fence = dr.cols, dr.klen, dr.fence
    if rows != dr.w + 1 or n_sets not in (1, 2):
        raise ValueError(f"queries {tuple(packed.shape)} do not fit a run "
                         f"of {dr.w} lanes")
    if not 1 <= dr.w <= MAX_LANES or not 1 <= dr.fence_len <= MAX_FENCE:
        raise ValueError(f"w={dr.w}, fence_len={dr.fence_len} outside the "
                         f"kernel's 1..{MAX_LANES}, 1..{MAX_FENCE}")
    for name, t in (("cols", cols), ("klen", klen), ("fence", fence),
                    ("queries", packed)):
        if t.dtype != torch.int64 or t.device != cols.device:
            raise TypeError(f"{name} must be int64 on {cols.device}, got "
                            f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its rows")
    packed = packed.contiguous()
    fence = fence.contiguous()
    out = torch.empty((nq, 2) if n_sets == 2 else (nq,), dtype=torch.int32,
                      device=cols.device)
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(cols.data_ptr(), cols.stride(0), klen.data_ptr(),
                       dr.w, dr.padded_len, dr.n, fence.data_ptr(),
                       dr.fence_len, dr.fence_step, steps, packed.data_ptr(),
                       nq, n_sets, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fence_lookup kernel launch failed: cudaError "
                           f"{err}")
    with _LAUNCHES_LOCK:
        LAUNCHES["fence_lookup"] += 1
    return out

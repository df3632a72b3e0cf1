"""The fence lookup of device reads as one hand-written CUDA kernel
(csrc/fence_lookup.cu).

Port of the XLA program pegasus_tpu/ops/device_lookup.py
_fence_lower_bound (inside _compiled_lookup and _compiled_range): each
query's lexicographic lower_bound over the run's lanes and key length;
for point lookups the equality check that gives the row or -1, for
ranges both bounds in the same launch. On a sorted run the reference's
fence window always holds that lower_bound, so the kernel searches the
whole run without it: a group of `group` lanes per query, each round one
load of `group` evenly spaced pivot rows and a ballot of which are below
the query (search_model is the same search in torch ops).

device_lookup.fence_lookup calls `launch` for runs on the card and the
plain version (device_lookup.fence_lookup_plain) for runs on the CPU. A
build or launch failure raises. LAUNCHES["fence_lookup"] counts launches
and is exported as the perf counter kernel.fence_lookup.launches.
"""

import ctypes
import threading

import torch

from ..runtime.perf_counters import counters
from .device_sort import lex_cmp

LAUNCHES = {"fence_lookup": 0}
# probes run on the RPC workers of a serving process
_LAUNCHES_LOCK = threading.Lock()
counters.gauge("kernel.fence_lookup.launches",
               lambda: LAUNCHES["fence_lookup"])

MAX_LANES = 16       # kMaxLanes
GROUPS = (8, 32)     # the kernel's lanes per query
# Up to this many queries a probe waits on its chain of rounds, which 32
# lanes per query make shortest; above it the sectors of its pivot loads
# bound it, and 8 lanes move a quarter of them (chip_smoke.py fence-ab,
# PERF.md: at 1024 queries 32 lanes were fastest, at 4096 8 lanes).
LARGE_PROBE = 1024

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_ENTRY = None


def _entry():
    global _ENTRY
    if _ENTRY is None:
        from ._build import load

        fn = load("fence_lookup").fence_lookup_i64
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY = fn
    return _ENTRY


def group_for(nq: int) -> int:
    """The kernel's lanes per query for a probe of nq queries."""
    return 8 if nq > LARGE_PROBE else 32


def launch(dr, packed: torch.Tensor, steps: int) -> torch.Tensor:
    """The kernel on a resident run `dr` and the int64 [n_sets, w + 1, q]
    query buffer on the same card -> int32 [q] (one set: rows or -1) or
    [q, 2] (two sets: [lo, max(hi, lo)]). `steps` is the plain version's
    depth (device_lookup.lookup_steps); the kernel's exact search equals
    the plain version only where that depth reaches every row."""
    return launch_group(dr, packed, steps, group_for(packed.shape[2]))


def launch_group(dr, packed: torch.Tensor, steps: int,
                 group: int) -> torch.Tensor:
    """launch with `group` lanes per query (one of GROUPS)."""
    n_sets, rows, nq = packed.shape
    cols, klen = dr.cols, dr.klen
    if rows != dr.w + 1 or n_sets not in (1, 2):
        raise ValueError(f"queries {tuple(packed.shape)} do not fit a run "
                         f"of {dr.w} lanes")
    if not 1 <= dr.w <= MAX_LANES or group not in GROUPS:
        raise ValueError(f"w={dr.w}, group={group} outside the kernel's "
                         f"1..{MAX_LANES}, {GROUPS}")
    if steps < dr.n.bit_length():
        raise ValueError(f"depth {steps} does not reach the {dr.n} rows")
    dev = cols.device
    for name, t in (("cols", cols), ("klen", klen), ("queries", packed)):
        if t.dtype != torch.int64 or t.device != dev:
            raise TypeError(f"{name} must be int64 on {dev}, got "
                            f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its rows")
    packed = packed.contiguous()
    out = torch.empty((nq, 2) if n_sets == 2 else (nq,), dtype=torch.int32,
                      device=dev)
    args = (cols.data_ptr(), cols.stride(0), klen.data_ptr(), dr.w, dr.n,
            packed.data_ptr(), nq, n_sets, group, out.data_ptr())
    if dev.index == torch.cuda.current_device():
        err = _entry()(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fence_lookup kernel launch failed: cudaError "
                           f"{err}")
    with _LAUNCHES_LOCK:
        LAUNCHES["fence_lookup"] += 1
    return out


def search_model(dr, packed: torch.Tensor, group: int = None) -> tuple:
    """The kernel's search in torch ops, round by round: the pivot
    spacing, the ballot's count, the last round over rows lo..hi and its
    equality, the clamps. -> (the answer in fence_lookup_plain's form,
    int64 [q] dependent rounds per query; a range's two sets run at once,
    so its rounds are the larger set's). For tests and measurements;
    reads take the kernel or fence_lookup_plain."""
    n_sets, _, nq = packed.shape
    g = group or group_for(nq)
    w, n = dr.w, max(dr.n, 0)
    lanes = torch.arange(g, device=packed.device)
    rounds = torch.zeros(nq, dtype=torch.int64, device=packed.device)
    los, hit = [], None
    for s in range(n_sets):
        qkey = [packed[s, j][:, None] for j in range(w + 1)]
        lo = torch.zeros(nq, dtype=torch.int64, device=packed.device)
        hi = torch.full_like(lo, n)
        r = torch.zeros_like(lo)
        while True:
            act = hi - lo >= g
            if not bool(act.any()):
                break
            length = hi - lo
            pivot = lo[:, None] + (lanes + 1) * length[:, None] // (g + 1)
            pivot = torch.where(act[:, None], pivot, 0)
            below = lex_cmp(_key_at(dr, pivot), qkey)[0]
            c = below.sum(1)
            nlo = torch.where(c == 0, lo, lo + c * length // (g + 1) + 1)
            nhi = torch.where(c == g, hi, lo + (c + 1) * length // (g + 1))
            lo = torch.where(act, nlo, lo)
            hi = torch.where(act, nhi, hi)
            r += act.to(r.dtype)
        row = lo[:, None] + lanes
        loaded = (row <= hi[:, None]) & (row < n)
        less, eq = lex_cmp(_key_at(dr, torch.where(loaded, row, 0)), qkey)
        c = (less & loaded & (row < hi[:, None])).sum(1)
        los.append(lo + c)
        hit = (eq & loaded).gather(1, c[:, None])[:, 0]
        rounds = torch.maximum(rounds, r + 1)
    if n_sets == 2:
        out = torch.stack([los[0], torch.maximum(los[1], los[0])], dim=1)
    else:
        out = torch.where(hit, los[0], -1)
    return out.to(torch.int32), rounds


def _key_at(dr, rows: torch.Tensor) -> list:
    return [dr.cols[j][rows] for j in range(dr.w)] + [dr.klen[rows]]

"""State carried over from the JAX package.

Two things cross from pegasus_tpu to the port:

  - resident runs: device_run_from_numpy takes the arrays of a
    pegasus_tpu DeviceRun (u32 lanes, klen, expire, hash32, bool deleted,
    each padded to the run's pow2 bucket and read out with np.asarray)
    and builds the port's DeviceRun on `device`, so both packages merge
    the same resident inputs;
  - engine directories: engine.LsmEngine opens a directory written by
    pegasus_tpu's LsmEngine as it is (same MANIFEST and SST format).
"""

import numpy as np
import torch

from .ops.compact import DeviceRun, resolve_device
from .ops.device_lookup import build_fence_index


def device_run_from_numpy(cols, klen, expire, deleted, hash32, n: int,
                          padded_len: int, w: int, device=None) -> DeviceRun:
    """-> the port's DeviceRun (int64 columns, fence index built) for the
    given padded u32/bool arrays. Raises on a shape that does not match
    (n, padded_len, w)."""
    device = resolve_device(device)
    cols = np.stack([np.asarray(c, dtype=np.uint32) for c in cols])
    if cols.shape != (w, padded_len) or not 0 < n <= padded_len:
        raise ValueError(f"run columns {cols.shape} do not match "
                         f"w={w}, padded_len={padded_len}, n={n}")

    def column(a, dtype):
        a = np.asarray(a)
        if a.shape != (padded_len,):
            raise ValueError(f"aux column {a.shape} != ({padded_len},)")
        return torch.from_numpy(a.astype(dtype)).to(device)

    dr = DeviceRun(
        cols=torch.from_numpy(cols.astype(np.int64)).to(device),
        klen=column(klen, np.int64), expire=column(expire, np.int64),
        deleted=column(deleted, np.bool_), hash32=column(hash32, np.int64),
        n=n, padded_len=padded_len, w=w)
    build_fence_index(dr)
    return dr

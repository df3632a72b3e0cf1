"""The port's two-run merge (pegasus_tpu_torch.ops.merge_path) against the
JAX package's merges.

On CPU tensors merge_path.merge_two_sorted runs the plain PyTorch merge;
it must equal, byte for byte, both device_sort.merge_two_sorted (the XLA
bitonic merge, trimmed to la+lb rows) and merge_two_sorted_pallas in
interpret mode, on the shapes of tests/test_pallas_merge.py and on the
cases aimed at the tiled CUDA kernel (chip_smoke.edge_cases). The plain
partition pass, merge_path_splits_plain, must equal the splits of the
plain merge's output at every tile boundary and the reference's
_diagonal_splits at its CHUNK boundaries. The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import functools
import os

import numpy as np
import pytest
import torch

import chip_smoke
from pegasus_tpu.ops import pallas_merge
from pegasus_tpu.ops.device_sort import merge_two_sorted as xla_merge
from pegasus_tpu_torch.ops import merge_path
from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain

NCOLS = 4
U32_PAD = np.uint32(0xFFFFFFFF)


def make_sorted(rng, n, ncols=NCOLS, lo=0, hi=1 << 20):
    prim = np.sort(rng.integers(lo, hi, size=n, dtype=np.uint32))
    rest = [rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
            for _ in range(ncols - 1)]
    order = np.lexsort(tuple(reversed([prim] + rest)))
    return [c[order] for c in [prim] + rest]


def _idx(A, B):
    la, lb = len(A[0]), len(B[0])
    return np.arange(la, dtype=np.int32), np.arange(la, la + lb,
                                                    dtype=np.int32)


def reference_merges(A, B, idx=None, with_pallas=True):
    """The JAX package's merges of the same columns + int32 idx (default
    the concat position), as numpy [ncols+1, la+lb]."""
    import jax.numpy as jnp

    la, lb, nk = len(A[0]), len(B[0]), len(A)
    ia, ib = idx or _idx(A, B)
    pad_fill = tuple([U32_PAD] * nk + [np.int32(-1)])
    a_ops = [jnp.asarray(c) for c in A] + [jnp.asarray(ia)]
    b_ops = [jnp.asarray(c) for c in B] + [jnp.asarray(ib)]
    outs = [xla_merge(a_ops, b_ops, nk, pad_fill)]
    if with_pallas:
        outs.append(pallas_merge.merge_two_sorted_pallas(a_ops, b_ops, nk,
                                                         pad_fill))
    return [np.stack([np.asarray(c)[: la + lb].astype(np.int64) for c in o])
            for o in outs]


def port_merge(A, B, idx=None):
    ia, ib = idx or _idx(A, B)
    a = torch.from_numpy(np.stack([c.astype(np.int64) for c in [*A, ia]]))
    b = torch.from_numpy(np.stack([c.astype(np.int64) for c in [*B, ib]]))
    return merge_path.merge_two_sorted(a, b, len(A)).numpy()


@pytest.mark.parametrize("la,lb,seed", [
    (1000, 1000, 0),
    (1, 5000, 1),
    (5000, 1, 2),
    (3000, 7001, 3),
    (2048, 2048, 4),
    (pallas_merge.CHUNK * 2 + 17, pallas_merge.CHUNK - 3, 5),
])
def test_plain_merge_matches_xla_and_pallas(la, lb, seed):
    rng = np.random.default_rng(seed)
    A, B = make_sorted(rng, la), make_sorted(rng, lb)
    got = port_merge(A, B)
    for want in reference_merges(A, B):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["disjoint", "disjoint_reversed",
                                  "equal_primary"])
def test_plain_merge_skewed_matches_xla_and_pallas(case):
    rng = np.random.default_rng(9)
    A, B = {
        "disjoint": lambda: (make_sorted(rng, 4000, lo=0, hi=1000),
                             make_sorted(rng, 4000, lo=10_000, hi=11_000)),
        "disjoint_reversed": lambda: (
            make_sorted(rng, 4000, lo=10_000, hi=11_000),
            make_sorted(rng, 4000, lo=0, hi=1000)),
        "equal_primary": lambda: (make_sorted(rng, 4096, lo=5, hi=6),
                                  make_sorted(rng, 4096, lo=5, hi=6)),
    }[case]()
    got = port_merge(A, B)
    for want in reference_merges(A, B):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nk", [2, 8, 10])
def test_plain_merge_key_widths_match_xla(nk):
    """nk spans the compaction range: one lane + kp up to 8 lanes + rank
    + kp. High-bit lanes and 0xFFFFFFFF pads must order unsigned."""
    rng = np.random.default_rng(20 + nk)
    A = make_sorted(rng, 700, nk, lo=0, hi=1 << 32)
    B = make_sorted(rng, 1300, nk, lo=0, hi=1 << 32)
    # 100 identical pad rows (all keys 0xFFFFFFFF, idx -1) close run A
    A = [np.concatenate([c, np.full(100, U32_PAD)]) for c in A]
    ia, ib = _idx(A, B)
    ia[700:] = -1
    got = port_merge(A, B, (ia, ib))
    want, = reference_merges(A, B, (ia, ib), with_pallas=False)
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=1)
def _kernel_cases():
    return {name: (a, b, nk) for name, a, b, nk in chip_smoke.kernel_cases()}


KERNEL_CASES = list(_kernel_cases())
EDGE_CASES = [name for name, *_ in chip_smoke.edge_cases(
    np.random.default_rng(0))]


def _columns(op, nk):
    """[nk+1, L] int64 operand -> (u32 key columns, int32 idx)."""
    return [op[c].astype(np.uint32) for c in range(nk)], \
        op[nk].astype(np.int32)


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_merge_edge_cases_match_xla_and_pallas(name):
    """Bench-shaped shared prefixes, one-sided window agreement, run
    lengths around half the kernel tile and one tile, and an all-pad
    tile. The reference's
    Pallas merge takes no empty run (its runs pad to >= 256 rows), so an
    empty run is held against the XLA merge alone."""
    a, b, nk = _kernel_cases()[name]
    (A, ia), (B, ib) = _columns(a, nk), _columns(b, nk)
    got = merge_path.merge_two_sorted(torch.from_numpy(a),
                                      torch.from_numpy(b), nk).numpy()
    wants = reference_merges(A, B, (ia, ib),
                             with_pallas=min(len(ia), len(ib)) > 0)
    for want in wants:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_splits_plain_match_plain_merge(name):
    a, b, nk = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                for x in _kernel_cases()[name])
    got = merge_path.merge_path_splits_plain(a, b, nk)
    tile = merge_path.TILE
    assert got.shape == (-(-(a.shape[1] + b.shape[1]) // tile) + 1,)
    assert torch.equal(got, chip_smoke.merged_splits(a, b, nk))
    # the public entry takes the plain version for CPU operands
    assert torch.equal(merge_path.merge_path_splits(a, b, nk), got)


@pytest.mark.parametrize("name", [
    n for n in KERNEL_CASES
    if min(x.shape[1] for x in _kernel_cases()[n][:2]) > 0])
def test_splits_plain_match_reference_diagonal_splits(name):
    """At the reference's CHUNK boundaries, which are the kernel's tile
    boundaries (runs of >= 1 row: the reference's search takes no empty
    run)."""
    import jax.numpy as jnp

    assert merge_path.TILE == pallas_merge.CHUNK
    a, b, nk = _kernel_cases()[name]
    n_chunks = -(-(a.shape[1] + b.shape[1]) // pallas_merge.CHUNK)
    want = pallas_merge._diagonal_splits(
        [jnp.asarray(c) for c in _columns(a, nk)[0]],
        [jnp.asarray(c) for c in _columns(b, nk)[0]], nk, n_chunks)
    got = merge_path.merge_path_splits_plain(
        torch.from_numpy(a), torch.from_numpy(b), nk)
    np.testing.assert_array_equal(got[:n_chunks].numpy(),
                                  np.asarray(want).astype(np.int64))


def test_merge_rejects_bad_operands():
    a = torch.zeros((3, 4), dtype=torch.int64)
    with pytest.raises(TypeError):
        merge_path.merge_two_sorted(a.to(torch.int32), a, 2)
    with pytest.raises(ValueError):
        merge_path.merge_two_sorted(a, torch.zeros((2, 4), dtype=torch.int64),
                                    2)
    with pytest.raises(ValueError):
        merge_path.merge_two_sorted(a, a, 4)


def test_cpu_operands_do_not_launch_the_kernel():
    before = merge_path.LAUNCHES["merge_path"]
    rng = np.random.default_rng(3)
    port_merge(make_sorted(rng, 50), make_sorted(rng, 60))
    assert merge_path.LAUNCHES["merge_path"] == before


def test_concurrent_builds_make_one_library(tmp_path, monkeypatch):
    """Threads that run the first merges of a cold process together build
    csrc/merge_path.cu once, into one library, without error (here a fake
    compiler command writes the output file)."""
    import sys
    import threading

    from pegasus_tpu_torch.ops import _build

    calls = []

    def fake_command(name, out):
        calls.append(out)
        return [sys.executable, "-c",
                "import sys, time; time.sleep(0.2); "
                "open(sys.argv[1], 'w').write('lib'); print('ptxas info')",
                out]

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_command", fake_command)
    reports, errors = [], []

    def worker():
        try:
            reports.append(_build.build("merge_path"))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(reports) == 8
    assert all(r.strip() == "ptxas info" for r in reports)
    assert len(calls) == 1
    libs = sorted(os.listdir(tmp_path))
    assert len(libs) == 2 and libs[0].endswith(".so") \
        and libs[1] == libs[0] + ".ptxas.txt"

"""The port's two-run merge (pegasus_tpu_torch.ops.merge_path) against the
JAX package's merges.

On CPU tensors merge_path.merge_two_sorted runs the plain PyTorch merge;
it must equal, byte for byte, both device_sort.merge_two_sorted (the XLA
bitonic merge, trimmed to la+lb rows) and merge_two_sorted_pallas in
interpret mode, on the shapes of tests/test_pallas_merge.py. The CUDA
kernel itself is held against the plain merge on the card (the `cuda`
marked test, and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.cuda
def test_merge_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: "
                    "python -m pytest -m cuda tests/test_torch_*.py)")
    import chip_smoke

    for name, a, b, nk in chip_smoke.kernel_cases():
        ta = torch.from_numpy(a).cuda()
        tb = torch.from_numpy(b).cuda()
        before = merge_path.LAUNCHES["merge_path"]
        got = merge_path.merge_two_sorted(ta, tb, nk)
        assert merge_path.LAUNCHES["merge_path"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, merge_two_sorted_plain(ta, tb, nk)), name

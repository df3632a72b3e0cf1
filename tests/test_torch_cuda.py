"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

This file imports neither jax nor the JAX package, so it runs on a
machine that may not run them: there, without the suite's conftest (which
sets JAX up for the CPU tests),

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each test skips without a card. The cases are chip_smoke.py's: the
merge-path kernel (2-D, two key widths from 8 threads at once, and
batched) and the fence-lookup kernel at every lanes-per-query choice,
each byte-equal to its plain version and counted as one launch. The card tests that compare with the JAX package
(tests/test_torch_onebox.py, test_torch_server.py) stay beside their CPU
twins.
"""

import pytest
import torch

import chip_smoke
from pegasus_tpu_torch.ops import merge_path
from pegasus_tpu_torch.ops.device_sort import merge_two_sorted_plain
from pegasus_tpu_torch.ops.fence_lookup import GROUPS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_merge_kernel_matches_plain_on_card(card):
    for name, a, b, nk in chip_smoke.kernel_cases():
        ta = torch.from_numpy(a).to(card)
        tb = torch.from_numpy(b).to(card)
        before = merge_path.LAUNCHES["merge_path"]
        got = merge_path.merge_two_sorted(ta, tb, nk)
        assert merge_path.LAUNCHES["merge_path"] == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, merge_two_sorted_plain(ta, tb, nk)), name
        # and the partition pass against the plain splits
        chip_smoke._check_merge(ta, tb, nk, name)


@pytest.mark.cuda
def test_merges_of_mixed_widths_from_many_threads_on_card(card):
    """nk 4 and 10 launched from 8 host threads at once (two tables'
    ingests): every merge byte-equal to the plain one."""
    rep = chip_smoke.check_mixed_widths(card)
    assert rep["nk"] == [4, 10] and rep["merges"] == 64


@pytest.mark.cuda
def test_batched_merge_kernel_matches_plain_on_card(card):
    for name, a, b, nk in chip_smoke.batched_kernel_cases():
        chip_smoke._check_batched(torch.from_numpy(a).to(card),
                                  torch.from_numpy(b).to(card), nk, name)


@pytest.mark.cuda
def test_fence_kernel_matches_plain_on_card(card):
    for name, dr, points, ranges, _, _ in chip_smoke.lookup_probe_cases(card):
        for group in (None,) + GROUPS:
            chip_smoke._check_fence(dr, points, name, group)
            chip_smoke._check_fence(dr, ranges, name, group)

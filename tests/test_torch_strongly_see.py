"""The port's strongly-see wrapper (babble_tpu_torch/ops/hopper_kernels.py)
against the JAX package's Pallas kernel, run in interpret mode on the
CPU. Tolerance: exact integer equality (the function is a count).

On the CPU the wrapper takes its plain version; the CUDA kernel itself
is held against that plain version on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from babble_tpu.ops.pallas_kernels import strongly_see_counts as jax_strongly_see_counts
from babble_tpu_torch.ops import hopper_kernels, kernels
from babble_tpu_torch.ops.hopper_kernels import (
    strongly_see_counts,
    strongly_see_counts_ref,
)

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

SHAPES = [(5, 7, 4), (64, 64, 64), (130, 200, 100)]
IDS = ["tiny", "square", "ragged"]


def _inputs(m, w, n):
    rng = np.random.default_rng(3)
    la = rng.integers(-1, 50, (m, n)).astype(np.int32)
    fd = rng.integers(0, 50, (w, n)).astype(np.int32)
    fd[rng.random((w, n)) < 0.2] = np.iinfo(np.int32).max  # unreached
    return la, fd


@pytest.mark.parametrize("m,w,n", SHAPES, ids=IDS)
def test_plain_version_matches_pallas_kernel(m, w, n):
    la, fd = _inputs(m, w, n)
    want = np.asarray(jax_strongly_see_counts(la, fd, interpret=True))
    got = strongly_see_counts_ref(torch.from_numpy(la), torch.from_numpy(fd))
    assert got.dtype == torch.int32
    assert got.shape == (m, w)
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("m,w,n", SHAPES, ids=IDS)
def test_cpu_tensor_takes_plain_version(m, w, n):
    la, fd = _inputs(m, w, n)
    before = strongly_see_counts.launches
    got = strongly_see_counts(torch.from_numpy(la), torch.from_numpy(fd))
    assert strongly_see_counts.launches == before  # no kernel launch on the CPU
    want = (la[:, None, :] >= fd[None, :, :]).sum(-1, dtype=np.int32)
    assert (got.numpy() == want).all()


def test_plain_version_clamped_final_chunk(monkeypatch):
    """A budget that leaves a ragged final chunk: the clamped start
    re-reads overlapping rows (idempotent) instead of truncating."""
    la, fd = _inputs(130, 200, 100)
    monkeypatch.setattr(kernels, "_bcast_budget", lambda device: 7 * 200 * 100)
    assert kernels.chunk_width(130, 200 * 100, 7 * 200 * 100) == 7
    got = strongly_see_counts_ref(torch.from_numpy(la), torch.from_numpy(fd))
    want = (la[:, None, :] >= fd[None, :, :]).sum(-1, dtype=np.int32)
    assert (got.numpy() == want).all()


def _bad_inputs():
    la, fd = _inputs(8, 8, 6)
    la_t, fd_t = torch.from_numpy(la), torch.from_numpy(fd)
    wide = torch.from_numpy(np.ascontiguousarray(np.tile(la, (1, 2))))
    return {
        "int64": ((la_t.to(torch.int64), fd_t), TypeError),
        "float32": ((la_t, fd_t.to(torch.float32)), TypeError),
        "non_contiguous": ((wide[:, ::2], fd_t), ValueError),
        "one_dim": ((la_t[0], fd_t), ValueError),
        "participant_mismatch": ((la_t[:, :5].contiguous(), fd_t), ValueError),
        "other_device": ((la_t.to("meta"), fd_t.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects(case):
    (la, fd), exc = _bad_inputs()[case]
    before = strongly_see_counts.launches
    with pytest.raises(exc):
        strongly_see_counts(la, fd)
    assert strongly_see_counts.launches == before


def test_kernel_build_is_lazy():
    """Importing the module compiles nothing: the library is built at
    the first launch on a CUDA tensor, never at import."""
    assert not hopper_kernels._libs or torch.cuda.is_available()
    assert all(src.exists() for src in hopper_kernels.SOURCES)

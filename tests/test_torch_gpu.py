"""The hand-written CUDA kernels against their plain PyTorch versions, and
the delta-overlay merge and fold on the card against the same calls on
the CPU.  Marked ``gpu``: without a CUDA device every test skips.  The
file imports nothing of JAX, so on a machine without it run it as

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.engine import cuda_kernels
from pilosa_tpu_torch.engine import kernels as tk
from pilosa_tpu_torch.exec.planes import _apply_plane_cells
from pilosa_tpu_torch.ingest import delta

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", 0)


def _words(seed: int, shape, dev) -> torch.Tensor:
    """~25% dense int32 words with 0x80000000 and 0xFFFFFFFF planted."""
    rng = np.random.default_rng(seed)
    w = (rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
         & rng.integers(0, 1 << 32, size=shape, dtype=np.uint32))
    w[..., 0] = 0x80000000
    w[..., -1] = 0xFFFFFFFF
    return torch.from_numpy(w.view(np.int32)).to(dev)


@pytest.mark.parametrize("s,r,w", [(954, 32, 32768), (13, 5, 1000),
                                   (13, 5, 1001), (3, 1, 3)])
def test_kernels_equal_plain(dev, s, r, w):
    plane = _words(s * r + w, (s, r, w), dev)
    filt = _words(w, (s, w), dev)
    col = plane[:, 0].contiguous()
    idx = torch.tensor([r - 1, 0, r - 1], dtype=torch.int32)  # repeats
    pairs = [
        (cuda_kernels.row_counts(plane), tk.row_counts_plain(plane)),
        (cuda_kernels.row_counts(plane, filt),
         tk.row_counts_plain(plane, filt)),
        (cuda_kernels.selected_row_counts(plane, idx),
         tk.selected_row_counts_plain(plane, idx)),
        (cuda_kernels.count(filt), tk.count_plain(filt)),
        (cuda_kernels.intersect_count(filt, col),
         tk.intersect_count_plain(filt, col)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)


def test_routing_launches_on_cuda_tensors(dev):
    plane = _words(1, (4, 8, 256), dev)
    cuda_kernels.reset_launches()
    tk.row_counts(plane)
    tk.selected_row_counts(plane, torch.tensor([1, 1], dtype=torch.int32))
    tk.count(plane[:, 0].contiguous())
    tk.intersect_count(plane[:, 0].contiguous(), plane[:, 1].contiguous())
    assert cuda_kernels.LAUNCHES == dict.fromkeys(cuda_kernels.LAUNCHES, 1)


def test_wrappers_refuse_bad_input(dev):
    plane = torch.zeros((2, 4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(IndexError):
        cuda_kernels.selected_row_counts(
            plane, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(TypeError):
        cuda_kernels.count(plane[:, 0].to(torch.int64))
    with pytest.raises(ValueError):
        cuda_kernels.count(plane[:, :, 0])  # not contiguous
    with pytest.raises(ValueError):
        cuda_kernels.row_counts(plane, torch.zeros((2, 7), dtype=torch.int32,
                                                   device=dev))


def _overlay(seed: int, s: int, r: int, w: int, n: int, c_pad: int):
    """``n`` live cells (sign-bit and all-ones values among them) padded
    to ``c_pad`` lanes with the out-of-range flat row ``s * r``."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(s * r * w, n, replace=False)
    rows = np.full(c_pad, s * r, np.int32)
    words = np.zeros(c_pad, np.int32)
    vals = np.zeros(c_pad, np.uint32)
    rows[:n], words[:n] = cells // w, cells % w
    vals[:n] = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    vals[0], vals[1] = 0x80000000, 0xFFFFFFFF
    return [torch.from_numpy(a.view(np.int32)) for a in (rows, words, vals)]


@pytest.mark.parametrize("s,r,w", [(13, 5, 1001), (40, 32, 32768)])
def test_delta_merge_equal_cpu(dev, s, r, w):
    plane = _words(s + r, (s, r, w), "cpu")
    filt = _words(w + 1, (s, w), "cpu")
    cells = _overlay(s, s, r, w, 37, 64)
    slots = torch.tensor([r - 1, 0, 0, r - 1], dtype=torch.int32)
    on = [t.to(dev) for t in (plane, filt, *cells)]
    for f_cpu, f_dev in ((None, None), (filt, on[1])):
        for red in (True, False):
            want = delta.adjusted_row_counts(plane, *cells, f_cpu,
                                             reduce_shards=red)
            got = delta.adjusted_row_counts(on[0], *on[2:], f_dev,
                                            reduce_shards=red)
            assert torch.equal(got.cpu(), want)
    want = delta.adjusted_selected_counts(plane, slots, *cells)
    got = delta.adjusted_selected_counts(on[0], slots, *on[2:])
    assert torch.equal(got.cpu(), want)


def test_apply_plane_cells_equal_cpu(dev):
    s, r, w = 13, 5, 1001
    plane = _words(3, (s, r, w), "cpu")
    rng = np.random.default_rng(9)
    flat = rng.choice(s * r * w, 300, replace=False)
    vals = rng.integers(0, 1 << 32, 300, dtype=np.uint32)
    resets = [4, s * r - 1]
    reset_vals = rng.integers(0, 1 << 32, (2, w), dtype=np.uint32)
    args = (flat // w, flat % w, vals, resets, reset_vals)
    want = _apply_plane_cells(plane, *args)
    on = plane.to(dev)
    got = _apply_plane_cells(on, *args)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(on.cpu(), plane)    # out of place on the card too

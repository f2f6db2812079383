"""The port's popcount kernels against the JAX package's Pallas kernels.

Plain PyTorch versions (what a CPU tensor runs) are held against
``pilosa_tpu.engine.pallas_kernels`` in interpret mode, as
``tests/test_pallas.py`` runs them, on the same numpy inputs; every
result is an integer, so the tolerance is exact equality.  The hand
kernels themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.engine import kernels as jk
from pilosa_tpu.engine import pallas_kernels as pk
from pilosa_tpu_torch.engine import cuda_kernels
from pilosa_tpu_torch.engine import kernels as tk
from pilosa_tpu_torch.testing import share_cpu_threads

share_cpu_threads()

W = 2048  # small word count keeps interpreter-mode kernels fast

# the arithmetic-shift trap: sign bit alone, all ones, and neighbours
EDGE_WORDS = np.array([0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x40000000,
                       0xC0000000, 1, 0], np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 tensor, same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _words(rng, shape) -> np.ndarray:
    """~25% dense words with the edge words planted along the last axis."""
    w = (rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
         & rng.integers(0, 1 << 32, size=shape, dtype=np.uint32))
    n = min(len(EDGE_WORDS), shape[-1])
    w[..., :n] = EDGE_WORDS[:n]
    return w


class TestPopcount:
    def test_edge_words(self):
        got = tk.popcount(_t(EDGE_WORDS)).numpy()
        np.testing.assert_array_equal(got, [1, 32, 31, 1, 2, 1, 0])

    def test_matches_swar_reference(self, rng):
        import jax.numpy as jnp
        x = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.uint32),
                            EDGE_WORDS])
        want = np.asarray(pk._popcount_u32(jnp.asarray(x)))
        np.testing.assert_array_equal(tk.popcount(_t(x)).numpy(), want)
        np.testing.assert_array_equal(want, np.bitwise_count(x))


class TestCount:
    @pytest.mark.parametrize("shape", [(3, W), (13, 1000), (1, 3)])
    def test_matches_pallas(self, rng, shape):
        x = _words(rng, shape)
        want = np.asarray(pk.count(x, interpret=True))
        np.testing.assert_array_equal(tk.count(_t(x)).numpy(), want)

    def test_leading_axes(self, rng):
        x = _words(rng, (2, 3, 64))
        np.testing.assert_array_equal(tk.count(_t(x)).numpy(),
                                      np.asarray(jk.count(x)))


class TestRowCounts:
    @pytest.mark.parametrize("shape", [(3, 10, W), (13, 5, 1000),
                                       (2, 1, W), (3, 4, 1001)])
    @pytest.mark.parametrize("filtered", [False, True])
    def test_matches_pallas(self, rng, shape, filtered):
        plane = _words(rng, shape)
        filt = _words(rng, (shape[0], shape[2])) if filtered else None
        want = np.asarray(pk.row_counts(plane, filt, interpret=True))
        got = tk.row_counts(_t(plane),
                            _t(filt) if filtered else None).numpy()
        np.testing.assert_array_equal(got, want)


class TestSelectedRowCounts:
    @pytest.mark.parametrize("slots", [[3, 7, 7], [0], [9, 9, 9, 9],
                                       [2, 5, 8, 8]])
    def test_matches_pallas(self, rng, slots):
        plane = _words(rng, (3, 10, W))
        idx = np.array(slots, np.int32)
        want = np.asarray(pk.selected_row_counts(plane, idx,
                                                 interpret=True))
        got = tk.selected_row_counts(_t(plane), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_single_row_plane(self, rng):
        plane = _words(rng, (13, 1, 1000))
        idx = np.zeros(3, np.int32)
        want = np.asarray(pk.selected_row_counts(plane, idx,
                                                 interpret=True))
        got = tk.selected_row_counts(_t(plane), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)


class TestIntersectCount:
    @pytest.mark.parametrize("shape", [(5, W), (13, 1000)])
    def test_matches_pallas(self, rng, shape):
        a, b = _words(rng, shape), _words(rng, shape)
        want = np.asarray(pk.intersect_count(a, b, interpret=True))
        np.testing.assert_array_equal(
            tk.intersect_count(_t(a), _t(b)).numpy(), want)


class TestBooleanAlgebra:
    @pytest.mark.parametrize("name", ["intersect", "union", "difference",
                                      "xor", "complement"])
    def test_matches_jax(self, rng, name):
        a, b = _words(rng, (2, 256)), _words(rng, (2, 256))
        want = np.asarray(getattr(jk, name)(a, b))
        got = getattr(tk, name)(_t(a), _t(b)).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)


class TestShardTotals:
    @pytest.mark.parametrize("n_shards", [1, 5, 2047, 2050])
    def test_matches_jax(self, rng, n_shards):
        counts = rng.integers(0, 1 << 20, size=(n_shards, 3),
                              dtype=np.int32)
        np.testing.assert_array_equal(
            tk.shard_totals(torch.from_numpy(counts)),
            jk.shard_totals(counts))


class TestRouting:
    def test_cpu_tensors_take_the_plain_version(self, rng):
        cuda_kernels.reset_launches()
        plane = _t(_words(rng, (2, 4, 64)))
        tk.row_counts(plane)
        tk.selected_row_counts(plane, torch.tensor([1, 1], dtype=torch.int32))
        tk.count(plane[:, 0])
        tk.intersect_count(plane[:, 0], plane[:, 1])
        assert cuda_kernels.LAUNCHES == dict.fromkeys(cuda_kernels.LAUNCHES, 0)

    @pytest.mark.parametrize("call", [
        lambda p: cuda_kernels.row_counts(p),
        lambda p: cuda_kernels.selected_row_counts(
            p, torch.zeros(1, dtype=torch.int32)),
        lambda p: cuda_kernels.count(p[:, 0]),
        lambda p: cuda_kernels.intersect_count(p[:, 0], p[:, 1]),
    ])
    def test_wrappers_refuse_cpu_tensors(self, call):
        with pytest.raises(ValueError, match="CUDA"):
            call(torch.zeros((2, 3, 8), dtype=torch.int32))

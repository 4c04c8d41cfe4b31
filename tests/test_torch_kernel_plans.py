"""The launch plans of two kernels of the PyTorch port, pinned on the CPU:
the mix kernel's slice width (``ops/gat_fused.py::mix_slice_cols``, the
columns of ``v`` that the whole card gathers from at a time, sized to the
card's L2) and the segment max's lanes per row
(``ops/segment_max.py::segment_max_lanes``). Both are pure functions of the
shapes and the card's L2 size; the kernels' outputs do not depend on them
(``tests/test_torch_cuda.py`` holds them bitwise across every width on the
card). Also the wrappers' checks of an explicit width, which run before
any device work."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_geometric_tpu_torch.ops.gat_fused import (
    MIX_L2_SHARE, MIX_MIN_SLICE_BYTES, gat_mix, gat_mix_plain,
    mix_slice_cols)
from pytorch_geometric_tpu_torch.ops.segment_max import (
    segment_max_blocked, segment_max_lanes, segment_max_plain)

H100_L2 = 50 * 2 ** 20   # what an H100 reports as its L2 size


@pytest.mark.parametrize('itemsize', [4, 2])
@pytest.mark.parametrize('n_src,h,f', [
    (100_000, 4, 64), (100_000, 4, 10), (100_000, 1, 256), (1_000, 8, 64),
    (2_000_000, 4, 64), (2_000_000, 3, 7), (300, 8, 33), (500_000, 16, 48)])
def test_slice_width_tiles_the_row_in_vectors(n_src, h, f, itemsize):
    """W divides H*F, is a multiple of the 16-byte vector where the vector
    divides H*F, and gathers at least a 128-byte line of a row unless it is
    the whole row."""
    hf, vec = h * f, 16 // itemsize
    w = mix_slice_cols(n_src, h, f, itemsize, H100_L2)
    assert 0 < w <= hf and hf % w == 0
    if hf % vec == 0:
        assert w % vec == 0
        assert w == hf or w * itemsize >= MIX_MIN_SLICE_BYTES
    else:
        assert w == hf


@pytest.mark.parametrize('itemsize', [4, 2])
def test_path_c_slice_stays_under_the_l2_budget(itemsize):
    """At path C's hidden layer (v [100,000, 256]: 102 MB in float32, 51 MB
    in bf16, both past the 50 MB L2) the slice fits the budget and is the
    widest that does."""
    n, h, f = 100_000, 4, 64
    w = mix_slice_cols(n, h, f, itemsize, H100_L2)
    budget = MIX_L2_SHARE * H100_L2
    assert w < h * f
    assert n * w * itemsize <= budget
    wider = [d for d in range(w + 1, h * f + 1) if (h * f) % d == 0
             and d % (16 // itemsize) == 0]
    assert all(n * d * itemsize > budget for d in wider)


@pytest.mark.parametrize('n_src,h,f,itemsize', [
    (100_000, 4, 10, 4), (100_000, 4, 10, 2), (30_000, 1, 128, 4),
    (700, 8, 64, 4), (10_000, 4, 64, 2), (0, 4, 64, 4)])
def test_v_that_fits_l2_is_one_slice(n_src, h, f, itemsize):
    """A v within the budget (path C's 40-wide last layer, the serving
    widths, small graphs) is gathered as one slice."""
    assert n_src * h * f * itemsize <= MIX_L2_SHARE * H100_L2
    assert mix_slice_cols(n_src, h, f, itemsize, H100_L2) == h * f


def test_slice_width_shrinks_with_the_cache_and_stops_at_a_line():
    """A smaller L2 takes narrower slices; when even the narrowest does not
    fit, the narrowest (one 128-byte line of a row) is taken."""
    n, h, f = 100_000, 4, 64
    widths = [mix_slice_cols(n, h, f, 4, l2) for l2 in
              (4 * H100_L2, H100_L2, H100_L2 // 4, 2 ** 20)]
    assert widths == sorted(widths, reverse=True)
    assert widths[0] == h * f and widths[-1] == MIX_MIN_SLICE_BYTES // 4


@pytest.mark.parametrize('n_dst', [1, 1000, 100_000])
def test_lanes_per_row_is_a_growing_power_of_two(n_dst):
    """G is a power of two in [1, 32], never falls as the mean run length
    grows, and gives each lane at most 8 slots of a mean row (more than 4
    where G > 1), until G reaches a warp."""
    last = 1
    for mean in [0, 0.5, 1, 2, 3, 4, 4.5, 8, 9, 16, 21, 33, 64, 100, 128,
                 129, 256, 257, 1000]:
        g = segment_max_lanes(int(mean * n_dst), n_dst)
        m = int(mean * n_dst) / n_dst
        assert 1 <= g <= 32 and g & (g - 1) == 0
        assert g >= last
        last = g
        if g < 32:
            assert m / g <= 8
        if g > 1:
            assert m / g > 4
    assert segment_max_lanes(21 * n_dst, n_dst) == 4   # path C: 21 per row


def test_lanes_per_row_without_rows():
    assert segment_max_lanes(0, 0) == 1


def _slots(rng, n_src, n_dst, e):
    dst = np.sort(rng.integers(0, n_dst, e))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst,
                                                        minlength=n_dst))])
    return (torch.as_tensor(indptr.astype(np.int32)),
            torch.as_tensor(rng.integers(0, n_src, e).astype(np.int32)))


@pytest.mark.parametrize('w', [0, -4, 3, 7, 80])
def test_gat_mix_refuses_a_width_that_does_not_tile(w):
    rng = np.random.default_rng(0)
    indptr, src = _slots(rng, 30, 40, 200)
    p = torch.rand(200, 4)
    v = torch.randn(30, 40)
    with pytest.raises(ValueError, match='slice_cols'):
        gat_mix(indptr, src, p, p, v, 10, slice_cols=w)


@pytest.mark.parametrize('w', [None, 1, 8, 20, 40])
def test_gat_mix_on_the_cpu_ignores_the_width(w):
    """A legal width changes nothing of the plain version that a CPU tensor
    runs, and launches nothing."""
    rng = np.random.default_rng(1)
    indptr, src = _slots(rng, 30, 40, 200)
    p_s, p_u = torch.rand(200, 4), torch.rand(200, 4)
    v = torch.randn(30, 40)
    before = gat_mix.launches
    s, u = gat_mix(indptr, src, p_s, p_u, v, 10, slice_cols=w)
    rs, ru = gat_mix_plain(indptr, src, p_s, p_u, v, 10)
    assert gat_mix.launches == before
    assert torch.equal(s, rs) and torch.equal(u, ru)


@pytest.mark.parametrize('lanes', [0, 3, 33, 64])
def test_segment_max_refuses_lanes_off_the_powers_of_two(lanes):
    rng = np.random.default_rng(2)
    indptr, _ = _slots(rng, 30, 40, 200)
    vals = torch.randn(200, 4)
    with pytest.raises(ValueError, match='power of two'):
        segment_max_blocked(vals, SimpleNamespace(indptr=indptr), 40,
                            lanes=lanes)


@pytest.mark.parametrize('lanes', [None, 1, 32])
def test_segment_max_on_the_cpu_ignores_the_lanes(lanes):
    rng = np.random.default_rng(3)
    indptr, _ = _slots(rng, 30, 40, 200)
    vals = torch.randn(200, 3)
    before = segment_max_blocked.launches
    out = segment_max_blocked(vals, SimpleNamespace(indptr=indptr), 40,
                              lanes=lanes)
    assert segment_max_blocked.launches == before
    assert torch.equal(out, segment_max_plain(indptr, vals))

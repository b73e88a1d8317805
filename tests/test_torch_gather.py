"""``ops/gather.py`` on the CPU: the row gathers from tables that carry a
gradient.  The forward is ``index_select``'s, bit for bit; the backward
(``segment_sum``: a stable sort of the rows, float64 prefix sums, each
row the difference at its segment's ends) equals ``index_add``'s within
float32 rounding of the sum (rtol 1e-6 against a float64 ``index_add``,
atol 1e-6 x the largest |sum|) and is ``torch.equal`` over two calls.
The card's test of the same (two backward passes of a gradient step bit
for bit) is in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from pnraytracing_tpu_torch.ops.gather import gather_row, gather_rows, segment_sum

# (rows, lanes, columns): few rows with long segments (materials), rows
# left empty, a lane count that is no multiple of the scan tile, one lane
CASES = [(4, 5000, 3), (1, 7, 1), (300, 70000, 2), (5, 1, 1), (2048, 3000, 12)]


def _lanes(n, r, c, seed=0):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, n, r))
    values = torch.from_numpy(rng.standard_normal((r, c)).astype(np.float32))
    return idx, values


@pytest.mark.parametrize("n,r,c", CASES)
def test_segment_sum_matches_index_add(n, r, c):
    idx, values = _lanes(n, r, c)
    got = segment_sum(idx, values, n)
    want = torch.zeros(n, c, dtype=torch.float64).index_add_(
        0, idx, values.double())
    assert got.dtype == torch.float32 and got.shape == (n, c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, segment_sum(idx, values, n))
    # rows no lane names are zero
    empty = torch.bincount(idx, minlength=n) == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


def test_segment_sum_int32_rows():
    idx, values = _lanes(9, 400, 2, seed=1)
    assert torch.equal(segment_sum(idx.to(torch.int32), values, 9),
                       segment_sum(idx, values, 9))


def test_gather_rows_forward_is_index_select():
    idx, _ = _lanes(6, 1000, 1, seed=2)
    tables = [torch.randn(6, 3), torch.randn(6)]
    for grad in (False, True):
        ts = [t.clone().requires_grad_(grad) for t in tables]
        got = gather_rows(idx, *ts)
        for g, t in zip(got, ts):
            assert torch.equal(g, t.detach().index_select(0, idx))
            assert (g.grad_fn is not None) == grad


def test_gather_rows_backward_equals_index_add():
    """Three tables gathered by one index (the material fields), one of
    them without a gradient: the backward equals ``index_select``'s (in
    float64) within float32 rounding, once for all the tables, and
    repeats bit for bit."""
    idx, _ = _lanes(6, 20000, 1, seed=3)

    def grads(gather, dtype=torch.float32):
        g = lambda s: torch.Generator().manual_seed(s)
        w = torch.linspace(-1.0, 1.0, 20000, dtype=dtype)
        tables = [torch.randn(6, 3, generator=g(4)).to(dtype),
                  torch.rand(6, generator=g(5)).to(dtype), torch.ones(6)]
        for t in tables[:2]:
            t.requires_grad_()
        b, r, f = gather(idx, *tables)
        loss = (b.sum(1) * w + r * w ** 2 + f.to(dtype)).sum()
        return torch.autograd.grad(loss, tables[:2])

    got = grads(gather_rows)
    want = grads(lambda i, *ts: [t.index_select(0, i) for t in ts],
                 torch.float64)
    for g, x in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), x.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(x.abs().max()))
    again = grads(gather_rows)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_gather_row_without_grad_is_plain():
    t = torch.randn(5, 2)
    idx = torch.tensor([4, 0, 0, 3])
    with torch.no_grad():
        out = gather_row(idx, t.requires_grad_())
    assert out.grad_fn is None and torch.equal(out, t[idx])

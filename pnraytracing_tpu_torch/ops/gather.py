"""Row gathers from tables that carry a gradient, with a reproducible
backward.

``index_select``'s backward is ``index_add``, whose CUDA path adds each
lane into its row with atomics: a material row collects ~262k lanes of a
512x512 frame in whatever order the atomics land, so two runs of one
gradient step differ in the last bits (and ``table[idx]``'s sort-based
backward sums each row's run of lanes serially: 1441 ms of device time
on a 512x512 backward, PERF.md).  :func:`gather_rows` has the forward of
``index_select``, bit for bit, and a backward that sums every row's
lanes in one fixed order (:func:`segment_sum`), on the CPU and on the
card alike.

The JAX package's counterpart is the transpose of its gathers, XLA's
scatter-add, which sums in a fixed order on the TPU.
"""

from __future__ import annotations

import torch

_TILE = 1024  # lanes a scan row holds (segment_sum)


def segment_sum(idx: torch.Tensor, values: torch.Tensor, n: int
                ) -> torch.Tensor:
    """``out[m] = sum of values[k] over the lanes k with idx[k] == m``,
    ``out`` [n, C] f32 for ``values`` [R, C] and ``idx`` [R] in [0, n),
    summed in an order fixed by the data alone.

    The lanes are sorted by row (a stable sort: equal rows keep lane
    order), their values prefix-summed in float64 along the sorted order
    and each row's sum read as the difference of the prefix at its
    segment's two ends.  The prefix is a scan of [C, tiles, 1024] rows
    along the last dimension, then of the [C + 1, tiles] tile totals:
    every scan has more than one row, so PyTorch runs its own
    fixed-order scan kernel on the card and never the single-row CUB
    scan, whose look-back may add in another order from run to run.
    float64 keeps the differences exact to far below float32 rounding:
    the result equals ``index_add`` in float32 up to that rounding."""
    r, c = values.shape
    dev = values.device
    s_idx, perm = torch.sort(idx, stable=True)
    v = values.index_select(0, perm).to(torch.float64).T  # [C, R]
    tiles = max(-(-r // _TILE), 1)
    v = torch.nn.functional.pad(v, (0, tiles * _TILE - r))
    within = v.reshape(c, tiles, _TILE).cumsum(-1)
    tot = torch.cat([within[..., -1],
                     torch.zeros(1, tiles, dtype=torch.float64, device=dev)])
    before = (tot.cumsum(-1) - tot)[:c]  # exclusive prefix of the tiles
    prefix = (within + before[..., None]).reshape(c, -1)[:, :r]
    prefix = torch.cat([torch.zeros(c, 1, dtype=torch.float64, device=dev),
                        prefix], dim=1)  # prefix[:, k] = sum of lanes < k
    bounds = torch.searchsorted(
        s_idx, torch.arange(n + 1, dtype=s_idx.dtype, device=dev))
    out = prefix.index_select(1, bounds[1:]) - prefix.index_select(
        1, bounds[:-1])
    return out.T.to(torch.float32)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, *tables):
        ctx.save_for_backward(idx)
        ctx.shapes = [t.shape for t in tables]
        return tuple(t.index_select(0, idx) for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        (idx,) = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        cols = [g.reshape(g.shape[0], -1)
                for g, want in zip(grads, need) if want]
        widths = [x.shape[1] for x in cols]
        n = next(s[0] for s, want in zip(ctx.shapes, need) if want)
        sums = segment_sum(idx, torch.cat(cols, dim=1), n).split(widths, 1)
        it = iter(sums)
        return (None, *(next(it).reshape(s) if want else None
                        for s, want in zip(ctx.shapes, need)))


def gather_rows(idx: torch.Tensor, *tables: torch.Tensor):
    """``tuple(t.index_select(0, idx) for t in tables)``; where any table
    requires a gradient, through one autograd node whose backward sums
    each row's lanes in a fixed order (:func:`segment_sum`), one sort of
    ``idx`` for all the tables.  The tables share their row count."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _GatherRows.apply(idx, *tables)
    return tuple(t.index_select(0, idx) for t in tables)


def gather_row(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """:func:`gather_rows` of one table."""
    return gather_rows(idx, table)[0]

"""The card check's leaky-ReLU kink allowance (chip_smoke.py `kink_bounds`,
`check_backward`), on the CPU in float64.

Where a pair's a0 = qn . cn lies within rounding of 0, two summation orders
can take different leaky-ReLU slopes (1 against 0.1), and the backward's
context and query rows of that pair move. Here a pair is placed at
a0 = +-1e-12 by hand, and the plain backward is evaluated on both sides:

* the two results differ in those two rows only, and there by no more
  than kink_bounds' row bound (and by a sizeable share of it, so the bound
  is not vacuous);
* check_backward at the f32 'prob' gate passes the flipped result with the
  bounds and fails it without them.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from demovlp_tpu_torch.ops import xattn_kernel as xk

BC, LS, BQ, LQ, D = 70, 6, 67, 5, 16  # 70 / 67 items: two 64-item blocks a side
LAM = 20.0


def _plain_backward64(ctx, qry, cmask, g):
    """direction_sim_bwd_plain's blocking, in the inputs' dtype (float64)."""
    dq_direct, dqn, dcn = torch.zeros_like(qry), torch.zeros_like(qry), torch.zeros_like(ctx)
    for c0 in range(0, ctx.shape[0], xk._BLOCK):
        cs = slice(c0, c0 + xk._BLOCK)
        for q0 in range(0, qry.shape[0], xk._BLOCK):
            qs = slice(q0, q0 + xk._BLOCK)
            a, b, c = xk._backward_block(ctx[cs], qry[qs], cmask[cs], g[cs, qs], LAM, False,
                                         False)
            dq_direct[qs] += a
            dqn[qs] += b
            dcn[cs] += c
    return xk._unit_backward(dcn, ctx), dq_direct + xk._unit_backward(dqn, qry)


def _flip_case(seed: int, pair):
    gen = torch.Generator().manual_seed(seed)
    ctx = torch.randn(BC, LS, D, generator=gen, dtype=torch.float64)
    qry = torch.randn(BQ, LQ, D, generator=gen, dtype=torch.float64)
    cmask = torch.zeros(BC, LS, dtype=torch.float64)
    cmask[:, -1] = -100.0  # one masked region an item
    g = torch.randn(BC, BQ, generator=gen, dtype=torch.float64)
    ci, si, qi, li = pair
    qn = qry[qi, li] / qry[qi, li].norm()
    ortho = ctx[ci, si] - (ctx[ci, si] @ qn) * qn
    out = []
    for a0 in (1e-12, -1e-12):
        c = ctx.clone()
        c[ci, si] = ortho + a0 * ortho.norm() * qn
        out.append((c, _plain_backward64(c, qry, cmask, g)))
    (c, (dc1, dq1)), (_, (dc2, dq2)) = out
    return (c, qry, cmask, g), (dc1, dq1), (dc2, dq2)


# (seed, (context item, region, query item, word)): pairs whose flip moves
# their rows by more than 1e-4, in each 64-item block of either side
CASES = [(0, (0, 0, 0, 0)), (0, (66, 2, 65, 4)), (1, (10, 1, 5, 2)), (0, (69, 3, 1, 3))]


@pytest.mark.parametrize("seed,pair", CASES,
                         ids=["first-blocks", "last-blocks", "first-blocks-seed1", "mixed-blocks"])
def test_flip_moves_its_rows_within_the_bound(seed, pair):
    (c, q, m, g), (dc1, dq1), (dc2, dq2) = _flip_case(seed, pair)
    cb, qb = chip_smoke.kink_bounds(c, q, m, g, LAM, False)
    ci, si, qi, li = pair
    assert cb[ci, si] > 1e-4 and qb[qi, li] > 1e-4
    ddc, ddq = (dc1 - dc2).abs(), (dq1 - dq2).abs()
    for diff, bound, row in ((ddc, cb, (ci, si)), (ddq, qb, (qi, li))):
        moved = float(diff[row].max())
        assert 0.2 * float(bound[row]) < moved <= float(bound[row])
        others = diff.clone()
        others[row] = 0
        assert float(others.max()) < 1e-9  # only the pair's rows move
    # the allowance is for kink rows only: few rows of the 400-odd a side
    assert 1 <= int((cb > 0).sum()) <= 3 and 1 <= int((qb > 0).sum()) <= 3


def test_check_backward_admits_the_flip_only_within_the_bound():
    (c, q, m, g), (dc1, dq1), (dc2, dq2) = _flip_case(*CASES[0])
    cb, qb = chip_smoke.kink_bounds(c, q, m, g, LAM, False)
    tol = chip_smoke.TOL_TRAIN["f32"]
    chip_smoke.check_backward("d_context", dc2, dc1, tol, (0.0, 0.0), cb)
    chip_smoke.check_backward("d_query", dq2, dq1, tol, (0.0, 0.0), qb)
    for got, want, bound in ((dc2, dc1, cb), (dq2, dq1, qb)):
        with pytest.raises(SystemExit):
            chip_smoke.check_backward("no allowance", got, want, tol, (0.0, 0.0),
                                      torch.zeros_like(bound))

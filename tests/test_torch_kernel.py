"""The CUDA local-similarity kernel's wrapper. Its argument checks run
here; the kernel itself runs only on a card (`gpu` marker: the test skips
when no card is visible, decided in the test body), where it is held
against its plain version. chip_smoke.py does the same at serving widths.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from demovlp_tpu_torch.ops import xattn_kernel as xk


def _inputs(bc, bq, ls, lq, d, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    ctx = torch.randn(bc, ls, d, generator=g)
    qry = torch.randn(bq, lq, d, generator=g)
    mask = ((torch.rand(bc, ls, generator=g) > 0.2).float() - 1.0) * 100.0
    mask[0] = -100.0  # one fully masked context item
    return ctx.to(device), qry.to(device), mask.to(device)


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda c, q, m: (c.double(), q, m), TypeError),
        (lambda c, q, m: (c.transpose(1, 2), q, m), ValueError),
        (lambda c, q, m: (c, q[..., :-1].contiguous(), m), ValueError),
        (lambda c, q, m: (c, q, m[:, :-1].contiguous()), ValueError),
    ],
    ids=["dtype", "contiguity", "depth", "mask-shape"],
)
def test_launch_checks_arguments(change, err):
    """Checked before anything is built or launched."""
    ctx, qry, mask = change(*_inputs(2, 3, 5, 4, 8))
    before = xk.LAUNCHES[xk.KERNEL]
    with pytest.raises(err):
        xk._launch(ctx, qry, mask, 20.0, True)
    assert xk.LAUNCHES[xk.KERNEL] == before


@pytest.mark.gpu
@pytest.mark.parametrize("focal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [(17, 13, 240, 99, 256),  # serving widths, ragged tiles
     (5, 6, 7, 9, 20)],  # D not a multiple of the 16-deep chunk
)
def test_kernel_matches_plain_on_card(shape, focal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask = _inputs(*shape, seed=1, device=dev)
    got = xk.direction_sim(ctx, qry, mask, 20.0, focal)
    want = xk.direction_sim_plain(ctx, qry, mask, 20.0, focal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-4)
    assert got[0].abs().max().item() == 0.0  # fully masked context: p = 0


@pytest.mark.gpu
def test_launcher_rejects_a_score_tile_too_large_for_a_block():
    """400 x 200 f32 scores (320 KB) exceed one block's shared memory: the
    launcher's own sizing refuses it, the wrapper raises and counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask = _inputs(2, 3, 400, 200, 8, device=dev)
    before = xk.LAUNCHES[xk.KERNEL]
    with pytest.raises(RuntimeError, match="cudaError_t"):
        xk.direction_sim(ctx, qry, mask, 20.0, True)
    assert xk.LAUNCHES[xk.KERNEL] == before


@pytest.mark.gpu
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("d", [20, 36, 256])
@pytest.mark.parametrize("ls,lq", [(240, 99), (99, 240), (13, 40), (300, 40)],
                         ids=["i2t", "t2i", "ragged", "wide"])
def test_tf32_forward_matches_plain_on_card(ls, lq, d, focal):
    """The f32 forward (xattn_sim_fwd_tf32_kernel, 3xTF32 products) at
    ragged shapes: Lq past a 64-row tile, Ls past an 8-column tile and (300)
    past the 256 columns whose softmax rows a warp keeps in registers, D
    past the 8-deep chunk and not a multiple of 8 (20, 36). 'prob' within 1e-5
    of the largest sim (3xTF32 reads about 3e-7 of it on the CPU emulation,
    tests/test_torch_tc_numerics.py); under 'equal' a near-tie may flip one
    position of Lq and move a sim by up to 2e-3, in at most 1% of the
    entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask = _inputs(6, 5, ls, lq, d, seed=2, device=dev)
    before = xk.LAUNCHES[xk.KERNEL]
    got = xk.direction_sim(ctx, qry, mask, 20.0, focal)
    want = xk.direction_sim_plain(ctx, qry, mask, 20.0, focal)
    torch.cuda.synchronize()
    assert xk.LAUNCHES[xk.KERNEL] == before + 1
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    tol = 1e-5 * float(want.abs().max())
    if focal:
        assert float((err > tol).float().mean()) <= 0.01 and float(err.max()) <= 2e-3
    else:
        assert float(err.max()) <= tol, float(err.max())
    assert got[0].abs().max().item() == 0.0  # fully masked context: p = 0


def _train_like_inputs(bc, bq, ls, lq, d, seed, device):
    """Ragged -100 positions holding zero vectors (inert padding) and one
    fully masked context item."""
    ctx, qry, mask = _inputs(bc, bq, ls, lq, d, seed=seed)
    ctx[1, ls // 2:] = 0.0
    mask[1, ls // 2:] = -100.0
    g = torch.randn(bc, bq, generator=torch.Generator().manual_seed(seed + 1))
    return ctx.to(device), qry.to(device), mask.to(device), g.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("shape", [(7, 5, 30, 11, 36), (6, 9, 13, 40, 20)])
def test_bwd_kernels_match_plain_on_card(shape, focal, bf16):
    """d_context and d_query from the two backward kernels against the plain
    backward, and the forward in the same mode, at small ragged shapes.
    f32: summation order only (atol 1e-4 on gradients of order 0.1; focal
    'equal' near-ties may flip one position of Lq, so the share of entries
    beyond it must stay under 1%). bf16: the same operands are rounded on
    both sides; a one-ulp flip of a rounded operand moves a gradient by
    about 2^-8 of its size, so 2e-3 absolute under the same share."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask, g = _train_like_inputs(*shape, seed=3, device=dev)
    if bf16:
        ctx, qry = xk.round_bf16(ctx), xk.round_bf16(qry)
    tol = 2e-3 if bf16 else 1e-4
    got = xk.direction_sim(ctx, qry, mask, 20.0, focal, bf16)
    want = xk.direction_sim_plain(ctx, qry, mask, 20.0, focal, bf16)
    dc, dq = xk.direction_sim_bwd(ctx, qry, mask, g, 20.0, focal, bf16)
    dc2, dq2 = xk.direction_sim_bwd(ctx, qry, mask, g, 20.0, focal, bf16)
    pdc, pdq = xk.direction_sim_bwd_plain(ctx, qry, mask, g, 20.0, focal, bf16)
    torch.cuda.synchronize()
    assert torch.equal(dc, dc2) and torch.equal(dq, dq2)  # no atomics: bit-identical
    for a, b in ((got, want), (dc, pdc), (dq, pdq)):
        assert torch.isfinite(a).all()
        err = (a - b).abs()
        assert float((err > tol).float().mean()) <= 0.01, float(err.max())
        assert float(err.max()) < 50 * tol


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("shape", [(6, 5, 240, 99, 256), (5, 6, 99, 240, 256)],
                         ids=["i2t", "t2i"])
def test_bwd_kernels_launch_at_f8_shapes(shape, focal, bf16):
    """The fine-tune shapes (f = 8 x k = 30 regions, 99 words, D = 256):
    the pair's tiles exceed one block's shared memory, so the launcher
    keeps them in the wrapper's device workspace. Same checks and
    tolerances as test_bwd_kernels_match_plain_on_card, and a fully masked
    context item gets exactly zero gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask, g = _train_like_inputs(*shape, seed=5, device=dev)
    if bf16:
        ctx, qry = xk.round_bf16(ctx), xk.round_bf16(qry)
    tol = 2e-3 if bf16 else 1e-4
    before = dict(xk.LAUNCHES)
    dc, dq = xk.direction_sim_bwd(ctx, qry, mask, g, 20.0, focal, bf16)
    dc2, dq2 = xk.direction_sim_bwd(ctx, qry, mask, g, 20.0, focal, bf16)
    pdc, pdq = xk.direction_sim_bwd_plain(ctx, qry, mask, g, 20.0, focal, bf16)
    torch.cuda.synchronize()
    assert xk.LAUNCHES[xk.KERNEL_DQ] == before[xk.KERNEL_DQ] + 2
    assert xk.LAUNCHES[xk.KERNEL_DC] == before[xk.KERNEL_DC] + 2
    assert torch.equal(dc, dc2) and torch.equal(dq, dq2)  # no atomics: bit-identical
    for a, b in ((dc, pdc), (dq, pdq)):
        assert torch.isfinite(a).all()
        err = (a - b).abs()
        assert float((err > tol).float().mean()) <= 0.01, float(err.max())
        assert float(err.max()) < 50 * tol
    assert float(dc[0].abs().max()) == 0.0  # item 0 is masked throughout


@pytest.mark.gpu
def test_bwd_launcher_rejects_vectors_too_large_for_a_block():
    """Lq = 9200 query rows: the staging buffers and the per-row vectors
    alone exceed one block's shared memory, which the workspace does not
    relieve, so the launcher refuses and the wrapper raises and counts
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask, g = _train_like_inputs(2, 3, 2, 9200, 4, seed=0, device=dev)
    before = dict(xk.LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        xk.direction_sim_bwd(ctx, qry, mask, g, 20.0, True, True)
    assert xk.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("shape", [(40, 37, 13, 11, 36), (40, 37, 240, 99, 64),
                                   (3, 37, 30, 11, 20), (9, 1, 11, 30, 20)],
                         ids=["40x37", "40x37-workspace", "3x37", "9x1"])
def test_bwd_kernels_ragged_splits(shape, focal, bf16):
    """The partner loop split over S blocks an item (backward_splits): 40
    contexts x 37 queries leaves d_context's 37 partners ragged over its S
    blocks (and d_query's 40 over its own on most slot counts), in the
    resident and the workspace layout (240 x 99 tiles); 3 x 37 and 9 x 1
    give a block a partner. Tolerances of test_bwd_kernels_match_plain_on_card;
    bit-identical reruns; one count a launcher call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask, g = _train_like_inputs(*shape, seed=7, device=dev)
    if bf16:
        ctx, qry = xk.round_bf16(ctx), xk.round_bf16(qry)
    bc, bq = shape[:2]
    s_dc, _ = xk.backward_plan(xk.KERNEL_DC, ctx, qry, bf16)
    s_dq, _ = xk.backward_plan(xk.KERNEL_DQ, ctx, qry, bf16)
    if bc == 40:
        assert s_dc > 1 and bq % s_dc != 0, s_dc
    if bc == 3:
        assert s_dc == bq
    if bq == 1:
        assert s_dq == bc
    tol = 2e-3 if bf16 else 1e-4
    before = dict(xk.LAUNCHES)
    dc, dq = xk.direction_sim_bwd(ctx, qry, mask, g, 20.0, focal, bf16)
    dc2, dq2 = xk.direction_sim_bwd(ctx, qry, mask, g, 20.0, focal, bf16)
    pdc, pdq = xk.direction_sim_bwd_plain(ctx, qry, mask, g, 20.0, focal, bf16)
    torch.cuda.synchronize()
    assert xk.LAUNCHES[xk.KERNEL_DQ] == before[xk.KERNEL_DQ] + 2
    assert xk.LAUNCHES[xk.KERNEL_DC] == before[xk.KERNEL_DC] + 2
    assert torch.equal(dc, dc2) and torch.equal(dq, dq2)  # no atomics: bit-identical
    for a, b in ((dc, pdc), (dq, pdq)):
        assert torch.isfinite(a).all()
        err = (a - b).abs()
        assert float((err > tol).float().mean()) <= 0.01, float(err.max())
        assert float(err.max()) < 50 * tol
    assert float(dc[0].abs().max()) == 0.0  # item 0 is masked throughout

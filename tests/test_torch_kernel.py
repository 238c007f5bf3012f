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

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
    """400 x 200 f32 scores (320 KB) exceed one block's shared memory (and
    every score-tile layout of the f32 kernel): the launcher's own sizing
    refuses it, the wrapper raises and counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask = _inputs(2, 3, 400, 200, 8, device=dev)
    before = xk.LAUNCHES[xk.KERNEL]
    with pytest.raises(RuntimeError, match="cudaError_t"):
        xk.direction_sim(ctx, qry, mask, 20.0, True)
    assert xk.LAUNCHES[xk.KERNEL] == before


# (Bc, Bq, Ls, Lq, D): the ragged shapes at 6 x 5 pairs; pairs fewer than
# the SMs and no multiple of the persistent grid (3 x 5, 7 x 19); the f = 8
# fine-tune's 32 x 32; the query call's 1000 videos x 64 texts, both ways
_TF32_CASES = (
    [pytest.param(6, 5, ls, lq, d, id=f"{name}-{d}")
     for name, (ls, lq) in (("i2t", (240, 99)), ("t2i", (99, 240)), ("ragged", (13, 40)),
                            ("wide", (300, 40)))
     for d in (20, 36, 256)]
    + [pytest.param(bc, bq, ls, lq, 256, id=f"{bc}x{bq}-{name}")
       for bc, bq in ((3, 5), (7, 19), (32, 32))
       for name, (ls, lq) in (("i2t", (240, 99)), ("t2i", (99, 240)))]
    + [pytest.param(1000, 64, 240, 99, 256, id="query-i2t"),
       pytest.param(64, 1000, 99, 240, 256, id="query-t2i")])


@pytest.mark.gpu
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("bc,bq,ls,lq,d", _TF32_CASES)
def test_tf32_forward_matches_plain_on_card(bc, bq, ls, lq, d, focal):
    """The f32 forward (l2norm_rows_tf32_kernel, then
    xattn_sim_fwd_tf32_kernel's 3xTF32 products) at ragged shapes: Lq past
    a 64-row tile, Ls past an 8-column tile and (300) past the 256 columns
    whose softmax rows a warp keeps in registers, D past the 8-deep stage
    and not a multiple of 8 (20, 36); at pair counts below and above the
    persistent grid, and at the fine-tune's and the query call's sizes.
    'prob' within 1e-5 of the largest sim (3xTF32 reads about 3e-7 of it
    on the CPU emulation, tests/test_torch_tc_numerics.py); under 'equal' a
    near-tie may flip one position of Lq and move a sim by up to 2e-3, in
    at most 1% of the entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask = _inputs(bc, bq, ls, lq, d, seed=2, device=dev)
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


@pytest.mark.gpu
def test_tf32_forward_counts_one_launch_a_direction():
    """Both directions of a query call, each once: LAUNCHES and
    SHAPE_LAUNCHES count one f32 forward a direction (the row pass and the
    main kernel are one launch of the counter), nothing in the bf16 mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    vid, txt, vmask = _inputs(40, 24, 240, 99, 256, seed=4, device=dev)
    tmask = torch.zeros(24, 99, device=dev)
    xk.reset_launch_counts()
    xk.direction_sim(vid, txt, vmask, 20.0, False)
    xk.direction_sim(txt, vid, tmask, 20.0, False)
    torch.cuda.synchronize()
    assert xk.LAUNCHES == {xk.KERNEL: 2, xk.KERNEL_BF16: 0, xk.KERNEL_DQ: 0, xk.KERNEL_DC: 0}
    assert xk.SHAPE_LAUNCHES == {(xk.KERNEL, 240, 99): 1, (xk.KERNEL, 99, 240): 1}


def _train_like_inputs(bc, bq, ls, lq, d, seed, device):
    """Ragged -100 positions holding zero vectors (inert padding) and one
    fully masked context item."""
    ctx, qry, mask = _inputs(bc, bq, ls, lq, d, seed=seed)
    ctx[1, ls // 2:] = 0.0
    mask[1, ls // 2:] = -100.0
    g = torch.randn(bc, bq, generator=torch.Generator().manual_seed(seed + 1))
    return ctx.to(device), qry.to(device), mask.to(device), g.to(device)


BF16_TOL, BF16_FLIP_TOL, BF16_FLIP_SHARE = 2e-3, 2e-2, 1e-2  # chip_smoke TOL_TRAIN["bf16"]


def _assert_bf16_forward_close(got, want):
    """chip_smoke's bf16 training tolerance: max |err| within 2e-3 of the
    largest plain sim, or within 2e-2 with at most 1% of the entries beyond
    2e-3 (an operand whose last f32 digit differs can round to the next
    bf16 value, and a focal near-tie can flip)."""
    assert torch.isfinite(got).all()
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    rel = float(err.max()) / scale
    share = float((err > BF16_TOL * scale).float().mean())
    assert rel <= BF16_TOL or (rel <= BF16_FLIP_TOL and share <= BF16_FLIP_SHARE), (rel, share)


def _bf16_forward_case(bc, bq, ls, lq, d, focal, seed):
    """The bf16 forward (xattn_sim_fwd_bf16_kernel) against the plain bf16
    version: one count a call, bit-identical reruns, zero for the fully
    masked context item 0 (with one context item, nothing is masked there);
    returns the launcher's split S."""
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask = _inputs(bc, bq, ls, lq, d, seed=seed)
    if bc > 1:  # item 1: ragged -100 positions holding zero vectors (inert padding)
        ctx[1, ls // 2:] = 0.0
        mask[1, ls // 2:] = -100.0
    else:
        mask[0] = 0.0
    ctx, qry, mask = xk.round_bf16(ctx).to(dev), xk.round_bf16(qry).to(dev), mask.to(dev)
    before = xk.LAUNCHES[xk.KERNEL_BF16]
    got = xk.direction_sim(ctx, qry, mask, 20.0, focal, True)
    again = xk.direction_sim(ctx, qry, mask, 20.0, focal, True)
    want = xk.direction_sim_plain(ctx, qry, mask, 20.0, focal, True)
    torch.cuda.synchronize()
    assert xk.LAUNCHES[xk.KERNEL_BF16] == before + 2
    assert torch.equal(got, again)  # one writer an output, fixed order: bit-identical
    _assert_bf16_forward_close(got, want)
    if bc > 1:
        assert float(got[0].abs().max()) == 0.0  # fully masked context: p = 0
    return xk.bf16_forward_splits(bc, bq, ls, lq, d)


@pytest.mark.gpu
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("ls,lq,d", [(30, 99, 256), (99, 30, 256), (240, 99, 256),
                                     (99, 240, 256), (13, 40, 20), (13, 40, 36),
                                     (13, 40, 256), (300, 40, 20), (300, 40, 36),
                                     (300, 40, 256)],
                         ids=["i2t-f1", "t2i-f1", "i2t-f8", "t2i-f8", "ragged-d20",
                              "ragged-d36", "ragged-d256", "wide-d20", "wide-d36",
                              "wide-d256"])
def test_bf16_forward_matches_plain_on_card(ls, lq, d, focal):
    """The bf16 tensor-core forward at the pre-training shapes (f = 1), the
    f = 8 shapes (the operands then read from device memory: the streamed
    instantiation), and ragged ones: Lq past a 16-row tile, Ls past 8, 16
    and 32 columns and (300) past the 256 softmax columns a warp keeps in
    registers, D (20, 36) not a multiple of 16 or of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _bf16_forward_case(7, 5, ls, lq, d, focal, seed=11)


@pytest.mark.gpu
@pytest.mark.parametrize("focal", [False, True], ids=["prob", "equal"])
@pytest.mark.parametrize("shape,split", [((40, 37, 30, 99, 64), "ragged"),
                                         ((37, 40, 99, 30, 64), "ragged"),
                                         ((1, 9, 30, 99, 36), "one"),
                                         ((9, 1, 30, 99, 36), "each")],
                         ids=["40x37-i2t", "37x40-t2i", "bc1", "bq1"])
def test_bf16_forward_partner_splits(shape, split, focal):
    """The partner walk split over S blocks a held item: 40 partners over
    S blocks with 40 % S != 0 (the query held at i2t, the context at t2i);
    Bc = 1 (one partner, S = 1) and Bq = 1 (one held query, a block each of
    the 9 partners)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    s = _bf16_forward_case(*shape, focal, seed=12)
    partners = 40 if split == "ragged" else shape[0]
    if split == "ragged":
        assert s > 1 and partners % s != 0, s
    elif split == "one":
        assert s == 1, s
    else:
        assert s == partners, s


@pytest.mark.gpu
def test_bf16_forward_refuses_tiles_too_large_for_a_block():
    """Lq = 200 rows of Ls = 400 scores: the f32 score tile and the bf16 P
    tile (about 500 KB) exceed one block's shared memory even with the
    operands left in device memory: the launcher refuses before any launch,
    the wrapper raises and counts nothing, and there is no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx, qry, mask = _inputs(2, 3, 400, 200, 8, device=dev)
    before = dict(xk.LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        xk.direction_sim(xk.round_bf16(ctx), xk.round_bf16(qry), mask, 20.0, True, True)
    assert xk.LAUNCHES == before
    assert xk.bf16_forward_splits(2, 3, 400, 200, 8) < 0


def rne_bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bf16 bit patterns of f32 values rounded to nearest, ties to even
    (what __float2bfloat16_rn does), by integer arithmetic."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def adversarial_norm_rows() -> np.ndarray:
    """(rows, 16) f32 rows whose sums of squares are exact in any order and
    whose norm is exactly 1 (so |x| + 1e-8 is 1.0 in f32 and x / (|x| + eps)
    is x): bf16 ties of both parities at four scales (n * 2^-12 with n
    halfway between two bf16 values), completed to norm 1 by four squares;
    f32 subnormals with a tie in their low 16 bits beside a 1; a zero row."""
    ties = [[257, -259, 514, 1028, 2056], [-263, 518, -1036, 2072, 261], [265, 522, 1044]]
    rows = []
    for t in ties:
        rest = 2 ** 24 - sum(v * v for v in t)
        rows.append(np.array(t + _four_squares(rest) + [0] * (12 - len(t)), np.float64)
                    * 2.0 ** -12)
    sub = np.array([0x00018000, 0x00028000, 0x80038000, 0x00008000, 0x00010000, 0x007F8000],
                   np.uint32).view(np.float32)
    rows.append(np.concatenate([[1.0], sub, np.zeros(16 - 1 - len(sub))]))
    rows.append(np.zeros(16))
    return np.stack(rows).astype(np.float32)


def _four_squares(n: int) -> list:
    """Four non-negative integers whose squares sum to n (greedy search)."""
    import math

    for a in range(math.isqrt(n), -1, -1):
        for b in range(math.isqrt(n - a * a), -1, -1):
            r = n - a * a - b * b
            for c in range(math.isqrt(r), -1, -1):
                d = math.isqrt(r - c * c)
                if d * d == r - c * c:
                    return [a, b, c, d]
    raise ValueError(n)


@pytest.mark.gpu
def test_bf16_row_norm_rounds_to_nearest_even_on_card():
    """The bf16 mode's row-norm pass (l2norm_rows_bf16_kernel) writes
    bf16(x / (|x| + eps)) and bf16(x) bit for bit as round_bf16 rounds the
    f32 values, on rows whose norm is exact: ties of both parities,
    subnormals, a zero row (0 and a zero norm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from demovlp_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    x = torch.from_numpy(adversarial_norm_rows()).to(dev)
    rows, d = x.shape
    xn = torch.empty((rows, d), dtype=torch.bfloat16, device=dev)
    raw = torch.empty_like(xn)
    norm = torch.empty(rows, dtype=torch.float32, device=dev)
    fn = xk._function(xk.KERNEL, "xattn_l2norm_rows_bf16")
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), xn.data_ptr(), raw.data_ptr(), norm.data_ptr(), rows, d,
                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want_norm = torch.sqrt(torch.sum(x.double() ** 2, -1)).float()
    assert torch.equal(norm, want_norm)
    want = (x / (want_norm[:, None] + 1e-8)).to(torch.bfloat16)
    assert torch.equal(xn.view(torch.int16), want.view(torch.int16))
    assert torch.equal(raw.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))


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

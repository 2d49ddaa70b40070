"""The chamfer kernel's launch plan (soft_intro_vae_torch.ops.chamfer_cuda.plan).

The kernel runs only on the card; its launch plan is plain Python and is held
here, on the CPU, to what the kernel relies on, at the 3D recipe's shape
(32, 2048, 2048), at odd shapes and at every shape chip_smoke.py checks on
the card:
  * every work item (b, s) is taken by one CTA, every CTA of the grid is
    resident at once (the launch is cooperative: two CTAs an SM), and every
    (b, y index) lies in one slice, staged in chunks once;
  * every item's warps visit every row of x once;
  * the dynamic shared memory holds the chunk and each warp's column keys of
    it, and leaves room for two CTAs an SM;
  * bulk copies only where every chunk starts on a 16-byte boundary and is a
    whole number of 16-byte units, and the mbarrier's byte count fits;
  * at the recipe's shape the launch fills the card: at least 132 CTAs, one
    item each.
"""

import pytest

import chip_smoke
from soft_intro_vae_torch.ops import chamfer_cuda
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401

RECIPE = (32, 2048, 2048)
ODD = [(3, 48, 96), (1, 24, 24), (2, 2047, 1000), (1, 1, 1)]
SHAPES = list(dict.fromkeys([RECIPE, *ODD, *chip_smoke.CHAMFER_CASES, *chip_smoke.TIE_CASES]))


def x_visits(p, n):
    """Rows an item's warps take, as the kernel's block loop walks them."""
    rows = []
    block = 32 * p.rows
    iters = -(-n // (p.warps * block))
    for warp in range(p.warps):
        for it in range(iters):
            blk = (it * p.warps + warp) * block
            rows += [blk + lane * p.rows + r for lane in range(32) for r in range(p.rows)
                     if blk + lane * p.rows + r < n]
    return rows


def chunks(p, m, s):
    """(first point, points) of each chunk of slice s."""
    s0, s1 = s * p.slice, min(m, (s + 1) * p.slice)
    return [(c0, min(p.chunk, s1 - c0)) for c0 in range(s0, s1, p.chunk)]


def check_plan(bsz, n, m, sms=chamfer_cuda.H100_SMS):
    p = chamfer_cuda.plan(bsz, n, m, sms)
    where = f"{(bsz, n, m)} on {sms} SMs: {p}"
    assert p.rows == chamfer_cuda.ROWS and p.threads == 32 * p.warps, where
    assert 1 <= p.warps <= chamfer_cuda.MAX_WARPS, where
    assert p.tile_x == 32 * p.rows * p.warps, where

    # items: each taken by one CTA; the grid resident at once
    items = bsz * p.slices
    assert 1 <= p.grid <= min(items, sms * chamfer_cuda.CTAS_PER_SM), where
    taken = sorted(item for cta in range(p.grid) for item in range(cta, items, p.grid))
    assert taken == list(range(items)), where

    # x: every item's warps visit every row once
    assert sorted(x_visits(p, n)) == list(range(n)), where

    # y: every slice holds some of it; every point staged once
    assert (p.slices - 1) * p.slice < m <= p.slices * p.slice, where
    staged = []
    for s in range(p.slices):
        for c0, length in chunks(p, m, s):
            assert 0 < length <= p.chunk <= chamfer_cuda.MAX_CHUNK, where
            staged += range(c0, c0 + length)
            if p.bulk:
                for b in range(min(bsz, 3)):  # a batch element's base is b * m points
                    assert (b * m + c0) * 12 % 16 == 0 and length * 12 % 16 == 0, where
                assert length * 12 < 2 ** 20, where  # the mbarrier's transaction count
    assert staged == list(range(m)), where
    assert p.bulk == (m % 4 == 0), where

    # shared memory: the chunk (16-byte aligned) and each warp's column keys,
    # with room for two CTAs an SM
    need = -(-12 * p.chunk // 16) * 16 + 8 * p.warps * p.chunk
    assert need <= p.smem <= chamfer_cuda.SMEM_PER_CTA, where
    assert chamfer_cuda.CTAS_PER_SM * (p.smem + chamfer_cuda.STATIC_SMEM) <= 227 * 1024, where
    return p


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_invariants(shape):
    check_plan(*shape)


def test_plan_fills_the_card_at_the_recipe_shape():
    p = check_plan(*RECIPE)
    assert p.grid >= 132
    # 256 items, one a CTA: 8 warps of 256 rows against a 256-point slice of
    # y, one chunk, bulk copies
    assert (p.warps, p.slices, p.slice, p.chunk, p.bulk, p.grid) == (8, 8, 256, 256, True, 256)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("shape", [RECIPE, (300, 24, 100), (1, 40000, 40001)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_on_other_cards(shape, sms):
    check_plan(*shape, sms=sms)


def test_plan_takes_items_in_turn_where_they_outnumber_the_ctas():
    p = check_plan(300, 24, 100)
    assert p.slices == 1 and p.grid == 264 < 300


def test_plan_streams_long_slices_in_chunks():
    for shape in [(133, 64, 5000), (133, 64, 5001), (133, 1800, 1600)]:
        p = check_plan(*shape)
        assert p.slices == 1 and p.slice > p.chunk, shape
    assert not check_plan(133, 64, 5001).bulk


def test_plan_refuses_an_empty_shape():
    with pytest.raises(ValueError, match="empty"):
        chamfer_cuda.plan(0, 16, 16)

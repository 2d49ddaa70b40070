"""The fused-norm kernels' launch plan (soft_intro_vae_torch.ops.adain_cuda.plan).

The kernels run only on the card; their launch plan is plain Python and is
held here, on the CPU, to what the kernels rely on, at every norm-site shape
of configs/ffhq256.yaml at LODs 0-6 (at batches 32 and 4, the sites found by
running the style nets on the meta device) and at the odd shape (3, 5, 7, 9),
in both dtypes and both directions:
  * the plan is one the C entry points accept (``bad_plan``, mirrored here);
  * an image's tiles cover its pixels once, each tile a contiguous run of
    whole pixels streamed in chunks of at most CHUNK_BYTES staged (or one
    pixel), and the threads of a CTA cover a chunk's (pixel, channel)
    elements once, walked as the kernels walk them;
  * where the plan works in units of 4 channels, every tile's run starts on a
    16-byte boundary and every pixel's run is whole units;
  * the tickets map one to one onto the sums and apply items, and every apply
    item's ticket follows all of its image's sums items' tickets, which is
    what keeps a launch free of deadlock whatever the card holds at once.
"""

import os

import pytest
import torch

from soft_intro_vae_torch.ops import adain_cuda
from soft_intro_vae_torch.train.style import StyleConfig
from tests.torch_port_fixtures import one_torch_thread  # noqa: F401
from tools.torch_norm_sites import pass_sites, step_mix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFHQ = StyleConfig.from_yaml(os.path.join(ROOT, "configs", "ffhq256.yaml"))
DTYPES = [torch.float32, torch.bfloat16]
ODD = (3, 5, 7, 9)
BATCHES = (32, 4)          # the benchmark's b32 cell and the smoke's batch


def site_shapes(lod, batch):
    cfg = FFHQ
    enc, gen = pass_sites(lod, batch, cfg.start_channel_count, cfg.max_channel_count,
                          cfg.layer_count, cfg.latent_space_size)
    return sorted({key[0] for key in (*enc, *gen)})


def item_of(p, images, ticket):
    """csrc/bias_act_norm.cu ``take_item``: (apply, image, tile) of a ticket."""
    block, tile = divmod(ticket, p.tiles)
    if block == 0:
        return False, 0, tile
    if block == 2 * images - 1:
        return True, images - 1, tile
    apply = block % 2 == 0
    return apply, (block // 2 - 1 if apply else (block + 1) // 2), tile


def entry_accepts(p, images, ch, size, es, arrays):
    """csrc/bias_act_norm.cu ``bad_plan``, negated."""
    if p.unit == adain_cuda.UNIT:
        if ch * es % 16:
            return False
    elif p.unit != 1:
        return False
    units = ch // p.unit
    need = (2 * (arrays * -(-p.chunk * ch * es // 16) * 16 + (p.chunk + 3) // 4 * 16)
            + 2 * p.unit * p.threads * 4)
    return (0 < images <= adain_cuda.MAX_IMAGES and p.rows >= 1
            and p.rows * units == p.threads <= adain_cuda.MAX_THREADS
            and p.chunk >= 1 and p.pixels >= 1 and p.tiles == -(-size // p.pixels)
            and p.grid == 2 * images * p.tiles
            and need <= p.smem <= adain_cuda.MAX_DYNAMIC_SMEM)


def chunk_elements(p, count, ch):
    """The (pixel, channel) elements of a chunk of ``count`` pixels the CTA's
    threads take, as the kernels' loops walk them."""
    units = ch // p.unit
    out = []
    for t in range(p.threads):
        u, r = t % units, t // units
        for px in range(r, count, p.rows):
            out.extend((px, u * p.unit + j) for j in range(p.unit))
    return out


def check_plan(shape, dtype, direction):
    bsz, ch, h, w = shape
    size = h * w
    es = torch.tensor([], dtype=dtype).element_size()
    arrays = 1 if direction == "fwd" else 2
    p = adain_cuda.plan(bsz, ch, size, dtype, direction)
    where = f"{shape} {dtype} {direction}: {p}"
    assert entry_accepts(p, bsz, ch, size, es, arrays), where
    assert p.unit == (adain_cuda.UNIT if ch * es % 16 == 0 else 1), where

    # tiles: every pixel of an image once, each tile a run of whole pixels,
    # streamed in chunks of whole pixels
    firsts = [t * p.pixels for t in range(p.tiles)]
    counts = [min(p.pixels, size - f) for f in firsts]
    assert all(c > 0 for c in counts) and sum(counts) == size, where
    assert arrays * p.chunk * ch * es <= max(adain_cuda.CHUNK_BYTES, arrays * ch * es), where
    assert p.tiles <= -(-size // p.chunk), where  # no more tiles than chunks
    chunks = [(f + k, min(p.chunk, c - k)) for f, c in zip(firsts, counts)
              for k in range(0, c, p.chunk)]
    assert sum(n for _, n in chunks) == size, where
    if p.unit > 1:
        assert all(f * ch * es % 16 == 0 for f, _ in chunks), where
        assert ch % p.unit == 0 and ch * es % 16 == 0, where
    # a CTA's threads take every (pixel, channel) of a chunk once
    for count in sorted({n for _, n in chunks}):
        elems = chunk_elements(p, count, ch)
        assert len(elems) == count * ch == len(set(elems)), where

    # tickets: one to one onto the items; an image's apply items after its sums items
    items = [item_of(p, bsz, t) for t in range(p.grid)]
    assert sorted(items) == sorted((a, b, t) for a in (False, True) for b in range(bsz)
                                   for t in range(p.tiles)), where
    last_sums = {}
    for ticket, (apply, b, _) in enumerate(items):
        if not apply:
            last_sums[b] = ticket
        else:
            assert b in last_sums and last_sums[b] < ticket, where
    return p


@pytest.mark.parametrize("direction", adain_cuda.DIRECTIONS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lod", list(range(7)))
def test_plan_covers_every_ffhq256_site(lod, dtype, direction):
    for batch in BATCHES:
        shapes = site_shapes(lod, batch)
        assert shapes and len(shapes) == lod + 2
        for shape in shapes:
            check_plan(shape, dtype, direction)


@pytest.mark.parametrize("direction", adain_cuda.DIRECTIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_odd_shape(dtype, direction):
    p = check_plan(ODD, dtype, direction)
    assert p.unit == 1 and p.tiles == 1  # C = 5: scalar elements; 63 pixels: one tile


def test_plan_tiers_at_lod6():
    # the tiles the source's header describes, at the LOD-6 b32 sites in bf16:
    # chunks of 32 KB staged, 256 threads, 4 channels a thread a step; tiles
    # of 256 KB at the two largest sites, more tiles where the card would
    # have fewer than 2 items a CTA slot
    for direction in adain_cuda.DIRECTIONS:
        arrays = 1 if direction == "fwd" else 2
        for bsz, ch, h, w in ((32, 64, 256, 256), (32, 128, 128, 128), (32, 256, 64, 64),
                              (32, 512, 32, 32)):
            p = adain_cuda.plan(bsz, ch, h * w, torch.bfloat16, direction)
            assert p.unit == 4 and p.threads == 256, p
            assert arrays * p.chunk * ch * 2 == adain_cuda.CHUNK_BYTES, p
            assert p.smem + adain_cuda.STATIC_SMEM <= 228 * 1024 // 3, p  # 3 CTAs an SM
            assert p.grid >= adain_cuda.ITEMS_PER_SLOT * adain_cuda.CTAS_PER_SM * 132, p
            if h >= 128:
                assert arrays * p.pixels * ch * 2 == adain_cuda.TILE_BYTES, p
        # a whole 4x4 image of 512 channels is one tile
        assert adain_cuda.plan(32, 512, 16, torch.bfloat16, direction).tiles == 1
        # 2x2 bf16 planes: 512 channels are still whole 16-byte units
        assert adain_cuda.plan(4, 512, 4, torch.bfloat16, direction).unit == 4


def test_plan_refuses_what_it_cannot_stage():
    with pytest.raises(ValueError, match="threads"):
        adain_cuda.plan(1, 2048, 16, torch.float32, "bwd")
    with pytest.raises(ValueError, match="images"):
        adain_cuda.plan(adain_cuda.MAX_IMAGES + 1, 8, 16, torch.float32, "fwd")
    with pytest.raises(ValueError, match="direction"):
        adain_cuda.plan(1, 1, 16, torch.float32, "sideways")
    with pytest.raises(TypeError):
        adain_cuda.plan(1, 1, 16, torch.float64, "fwd")
    with pytest.raises(ValueError, match="empty"):
        adain_cuda.plan(0, 1, 16, torch.float32, "fwd")


@pytest.mark.parametrize("images,size,ch", [(1, 63, 5), (2, 15, 12), (3, 5000, 64),
                                            (7, 4096, 256)])
def test_plan_items_keep_sums_before_apply(images, size, ch):
    # the ticket order at small and multi-tile shapes, both directions and types
    for dtype in DTYPES:
        for direction in adain_cuda.DIRECTIONS:
            check_plan((images, ch, size, 1), dtype, direction)


def test_step_mix_matches_the_launch_count():
    # the per-step launches the site timings weigh by: 14 sites a pass, 13
    # passes forward, 12 with a gradient (chip_smoke.style_step_launches)
    import chip_smoke

    mix = step_mix(6, 4)
    got = tuple(sum(v for k, v in mix.items() if k[0] == d) for d in adain_cuda.DIRECTIONS)
    assert got == chip_smoke.style_step_launches(6, 0, 1) == (182, 168)
    assert sorted({k[1] for k in mix}, key=lambda s: -s[2]) == list(chip_smoke.SITE_SHAPES)

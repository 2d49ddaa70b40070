"""The fused-norm kernels' launch plan (soft_intro_vae_torch.ops.adain_cuda.plan).

The kernels run only on the card; their launch plan is plain Python and is
held here, on the CPU, to what the kernels rely on, at every norm-site shape
of configs/ffhq256.yaml at LODs 0-6 (the batch of LOD_2_BATCH_1GPU, the
sites found by running the style nets on the meta device) and at the odd
shape (3, 5, 7, 9), in both dtypes and both directions:
  * the CTAs' staged runs tile the B*C planes, every element once, a run
    never spans two planes unless it holds whole planes;
  * the dynamic shared memory fits one CTA (227 KB, less the kernels' static
    share) and holds the staged runs;
  * the cluster size is a power of two of at most 8 and divides the CTAs;
  * where the plan works in 16-byte units, every run and every plane starts
    on a 16-byte boundary and is a whole number of units.
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


def site_shapes(lod):
    cfg = FFHQ
    batch = cfg.lod_2_batch_tables["1GPU"][lod]
    enc, gen = pass_sites(lod, batch, cfg.start_channel_count, cfg.max_channel_count,
                          cfg.layer_count, cfg.latent_space_size)
    return sorted({key[0] for key in (*enc, *gen)})


def staged_runs(p, planes, size):
    """(CTA, first element, elements) of every CTA's staged run, as the kernels'
    ``segment`` computes them; element i of the launch is plane i // size."""
    out = []
    for cta in range(p.grid):
        rank = cta % p.cluster
        p0 = cta // p.cluster * p.planes_per_cta
        start = rank * p.slice
        if p.planes_per_cta == 1:
            n = max(0, min(size - start, p.slice))
        else:
            n = (min(planes, p0 + p.planes_per_cta) - p0) * size
        out.append((cta, p0 * size + start, n))
    return out


def check_plan(shape, dtype, direction):
    bsz, ch, h, w = shape
    size, planes = h * w, bsz * ch
    es = torch.tensor([], dtype=dtype).element_size()
    arrays = 1 if direction == "fwd" else 2
    p = adain_cuda.plan(bsz, ch, size, dtype, direction)
    where = f"{shape} {dtype} {direction}: {p}"

    assert p.tier in ("small", "plane", "cluster"), where
    assert p.planes_per_cta * p.lanes == p.threads <= adain_cuda.MAX_THREADS, where
    assert p.threads % 32 == 0 and (p.lanes <= 32 or p.lanes == p.threads), where
    assert p.lanes & (p.lanes - 1) == 0, where
    # cluster: a power of two, at most 8, one plane per CTA, dividing the grid
    assert p.cluster in (1, 2, 4, 8) and p.cluster <= adain_cuda.MAX_CLUSTER, where
    assert p.grid % p.cluster == 0, where
    assert (p.tier == "cluster") == (p.cluster > 1), where
    if p.cluster > 1:
        assert p.planes_per_cta == 1, where
    assert p.tier != "small" or size <= adain_cuda.SMALL_SIZE, where
    # shared memory: holds the staged runs, fits one CTA
    need = arrays * -(-p.planes_per_cta * p.slice * es // 16) * 16
    assert need <= p.smem <= adain_cuda.MAX_DYNAMIC_SMEM < 227 * 1024, where

    # every element of every plane staged by exactly one CTA
    runs = sorted(staged_runs(p, planes, size), key=lambda r: r[1])
    assert len(runs) == p.grid and all(n > 0 for _, _, n in runs), where
    pos = 0
    for _, start, n in runs:
        assert start == pos, where
        pos += n
        if p.planes_per_cta > 1:
            assert start % size == 0 and n % size == 0, where
        else:
            assert start // size == (start + n - 1) // size, where
    assert pos == planes * size, where
    if p.cluster > 1:
        per_plane = [sum(1 for _, s, _ in runs if s // size == q) for q in range(planes)]
        assert set(per_plane) == {p.cluster}, where

    # 16-byte units only where every run and plane starts on a 16-byte boundary
    assert p.unit in (1, 16 // es), where
    if p.unit > 1:
        assert size * es % 16 == 0 and p.slice % p.unit == 0, where
        for _, start, n in runs:
            assert start * es % 16 == 0 and n * es % 16 == 0, where
    else:
        assert size * es % 16 != 0, where
    return p


@pytest.mark.parametrize("direction", adain_cuda.DIRECTIONS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lod", list(range(7)))
def test_plan_covers_every_ffhq256_site(lod, dtype, direction):
    shapes = site_shapes(lod)
    assert shapes and len(shapes) == lod + 2
    for shape in shapes:
        check_plan(shape, dtype, direction)


@pytest.mark.parametrize("direction", adain_cuda.DIRECTIONS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_odd_shape(dtype, direction):
    p = check_plan(ODD, dtype, direction)
    assert p.tier == "small" and p.unit == 1  # S = 63: scalar elements


def test_plan_tiers_at_lod6():
    # the tiers the source's header describes, at the LOD-6 sites in bf16
    def plan(shape, direction):
        bsz, ch, h, w = shape
        return adain_cuda.plan(bsz, ch, h * w, torch.bfloat16, direction)

    for direction in adain_cuda.DIRECTIONS:
        arrays = 1 if direction == "fwd" else 2
        # the 256x256 planes (128 KB of bf16 x) go to clusters: the least Q
        # that brings a CTA's staging to STAGE_TARGET, at least two CTAs an SM
        top = plan((4, 64, 256, 256), direction)
        plane_bytes = arrays * 2 * 256 * 256
        assert top.tier == "cluster" and top.cluster * adain_cuda.STAGE_TARGET >= plane_bytes
        assert top.cluster // 2 * adain_cuda.STAGE_TARGET < plane_bytes
        assert 2 * (top.smem + adain_cuda.STATIC_SMEM) <= 228 * 1024
        assert plan((4, 512, 32, 32), direction).tier == "plane"
        assert plan((4, 512, 16, 16), direction).tier == "small"
        # 2x2 bf16 planes (8 bytes) are smaller than a unit: scalar elements
        assert plan((4, 512, 2, 2), direction).unit == 1


def test_plan_refuses_what_it_cannot_stage():
    with pytest.raises(ValueError, match="does not fit"):
        adain_cuda.plan(1, 1, 512 * 512, torch.float32, "bwd")
    with pytest.raises(ValueError, match="direction"):
        adain_cuda.plan(1, 1, 16, torch.float32, "sideways")
    with pytest.raises(TypeError):
        adain_cuda.plan(1, 1, 16, torch.float64, "fwd")
    with pytest.raises(ValueError, match="empty"):
        adain_cuda.plan(0, 1, 16, torch.float32, "fwd")


def test_step_mix_matches_the_launch_count():
    # the per-step launches the site timings weigh by: 14 sites a pass, 13
    # passes forward, 12 with a gradient (chip_smoke.style_step_launches)
    import chip_smoke

    mix = step_mix(6, 4)
    got = tuple(sum(v for k, v in mix.items() if k[0] == d) for d in adain_cuda.DIRECTIONS)
    assert got == chip_smoke.style_step_launches(6, 0, 1) == (182, 168)
    assert sorted({k[1] for k in mix}, key=lambda s: -s[2]) == list(chip_smoke.SITE_SHAPES)

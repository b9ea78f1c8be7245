"""The segment_combine kernels' launch geometry against the card's limits.

``kernel.launch_geometry`` is plain Python, so it is checked here on the
CPU for every ``nb`` in [1, 1024], ``eb`` up to 4096 and ``F`` up to 256:
at most 48 KB of shared memory a block without the opt-in (227 KB with
it), at most 1024 threads a block, a grid within ``INT_MAX``, and the
shapes the CUDA source assumes (lane tiles of whole 32-lane chunks, an
int16 sort, loads that divide F and fit the data's alignment).  The C
entry points check the same values again on the card
(``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.segment_combine import kernel as tkernel  # noqa: E402

NB = range(1, tkernel.MAX_NB + 1)
EB = sorted({0, 1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 511,
             512, 513, 1000, 1023, 1024, 1025, 2047, 2048, 2049, 3000, 4095,
             4096})
F_ALL = range(1, 257)
ROWS = [1, 7, 1_387_616, 2 ** 40]


def _limits(geo):
    assert 1 <= geo.warps and 32 * geo.warps <= tkernel.MAX_THREADS
    assert 0 < geo.smem_bytes <= tkernel.SMEM_MAX
    assert 1 <= geo.blocks <= tkernel.INT_MAX
    assert geo.lane_tile % 32 == 0


def test_scalar_geometry_within_the_card_limits():
    for nb in NB:
        for eb in EB:
            geo = tkernel.launch_geometry(1_387_616, eb, nb)
            _limits(geo)
            # acc[nb] and group[nb] a warp, 16-byte rows; the default
            # 48 KB suffices
            assert geo.smem_bytes == geo.warps * -(-nb // 4) * 32
            assert geo.smem_bytes <= tkernel.SMEM_DEFAULT
            assert geo.warps == min(tkernel.WARPS, 48 * 1024 // (
                geo.smem_bytes // geo.warps))
            assert 32 <= geo.lane_tile <= tkernel.SCALAR_MAX_TILE
            assert geo.vec == 1


@pytest.mark.parametrize("F", [1, 2, 3, 4, 31, 32, 33, 63, 64, 65, 127, 128,
                               129, 130, 255, 256])
def test_vector_geometry_within_the_card_limits(F):
    for nb in NB:
        for eb in EB:
            for align in (4, 8, 16):
                geo = tkernel.launch_geometry(1_387_616, eb, nb, F, align)
                _limits(geo)
                assert geo.smem_bytes <= tkernel.SMEM_DEFAULT
                # the sort: int32 end[nb] and group[nb], int16 perm[tile]
                per_warp = 8 * -(-nb // 4) * 4 + 2 * geo.lane_tile
                assert geo.smem_bytes == geo.warps * per_warp
                assert geo.warps == min(tkernel.WARPS,
                                        tkernel.SMEM_DEFAULT // per_warp)
                assert 32 <= geo.lane_tile <= tkernel.VEC_MAX_TILE < 2 ** 15
                assert geo.lane_tile >= min(eb, tkernel.VEC_MAX_TILE)
                assert geo.vec in (1, 2, 4)
                assert F % geo.vec == 0 and align % (4 * geo.vec) == 0


def test_vector_width_for_every_feature_count():
    """Every F up to 256 gets a load width that divides it and leaves no
    thread of a warp idle where a narrower width would fill it; the main
    path's widths keep all 32 threads busy."""
    for F in F_ALL:
        vec = tkernel.launch_geometry(100, 64, 128, F).vec
        assert F % vec == 0
        assert vec == 1 or F // vec >= 32
    assert tkernel.launch_geometry(100, 64, 128, 32).vec == 1
    assert tkernel.launch_geometry(100, 64, 128, 64).vec == 2
    assert tkernel.launch_geometry(100, 64, 128, 128).vec == 4
    assert tkernel.launch_geometry(100, 64, 128, 64, align=4).vec == 1


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("n_sm", [1, 132, 100_000])
def test_grid_within_int_max(R, n_sm):
    """One wave of the blocks an SM holds at least (the kernels' launch
    bounds), fewer when there are fewer rows than warps; a grid stride
    covers the rest."""
    for F, per_sm in ((None, tkernel.SCALAR_BLOCKS), (1, tkernel.VEC_BLOCKS),
                      (64, tkernel.VEC_BLOCKS), (256, tkernel.VEC_BLOCKS)):
        for nb in (1, 128, 1024):
            geo = tkernel.launch_geometry(R, 64, nb, F, n_sm=n_sm)
            _limits(geo)
            assert geo.blocks == min(n_sm * per_sm, -(-R // geo.warps))


def test_geometry_refuses_nb_outside_the_kernels_range():
    for nb in (0, tkernel.MAX_NB + 1):
        with pytest.raises(ValueError, match="nb"):
            tkernel.launch_geometry(10, 64, nb)

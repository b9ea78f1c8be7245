"""The flash attention and SSD scan kernels' launch geometry against the
card's limits.

``launch_geometry`` of each wrapper is plain Python, so it is checked here
on the CPU: flash for every head dim in {16, 32, 64, 128, 256} and its
three types (float32, bfloat16, float16: the half types stage the same),
the SSD passes for every P and N in [1, 128] and every chunk in [1, 128].
Shared memory stays within the 232,448 bytes a block may opt in to, a
block within 1024 threads, the grids within their axes' limits, and the
main path's shapes (and a rank's of the serving mesh) keep the blocks an
SM the sources' launch bounds ask for.  The wrappers pass this geometry to the C entry points, which refuse
any other (``tests/test_torch_cuda.py`` checks that on the card).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402

SM_SHARED = 233472       # shared bytes of an SM (228 KB) ...
BLOCK_RESERVED = 1024    # ... of which the runtime keeps 1 KB a block
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _fits(smem: int, blocks: int) -> bool:
    return blocks * (smem + BLOCK_RESERVED) <= SM_SHARED


@pytest.mark.parametrize("d", fk.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_geometry_within_the_card_limits(d, dtype):
    geo = fk.launch_geometry(d, dtype)
    assert geo.threads == fk.THREADS <= 1024 and geo.threads % 32 == 0
    assert geo.q_tile == 16 * geo.rows and geo.k_tile == fk.K_TILE
    assert geo.rows == {128: 4, 256: 2}.get(d, 8)
    # 64 outputs a thread from d = 64 on: rows x d/8
    assert geo.rows * d // 8 == min(64, 8 * d // 8)
    # each thread's scores: rows x 8 of the 64-key tile
    assert (geo.threads // 8) * geo.rows == geo.q_tile
    assert 8 * 8 == geo.k_tile
    assert 0 < geo.smem_bytes <= fk.SMEM_MAX
    # Q, one K and one V tile and the probability tile, all float32
    assert geo.smem_bytes >= 4 * (geo.q_tile + 2 * geo.k_tile) * d
    assert geo.smem_bytes % 16 == 0
    assert geo.min_blocks == (1 if d >= 128 else 2)
    if dtype == torch.float32:
        # the float32 path holds the blocks its launch bounds ask for
        assert _fits(geo.smem_bytes, geo.min_blocks)


@pytest.mark.parametrize("BH,Sq", [(1, 1), (100, 2048), (100, 2112),
                                   (fk.MAX_BH, 128), (7, 128 * 65535)])
@pytest.mark.parametrize("d", fk.HEAD_DIMS)
def test_flash_grid_within_its_limits(BH, Sq, d):
    geo = fk.launch_geometry(d, torch.float32, BH, Sq)
    bh, tiles = geo.grid
    assert bh == BH and 1 <= bh <= 2 ** 31 - 1
    assert tiles == -(-Sq // geo.q_tile) and tiles * geo.q_tile >= Sq
    if d < 128:
        assert tiles <= fk.MAX_Q_TILES


def test_flash_main_path_geometry():
    """Hymba-1.5B's prefill: 100 (batch, head) rows of 2048 queries at
    d=64 in float32: 16 query tiles of 128, two blocks an SM."""
    geo = fk.launch_geometry(64, torch.float32, 100, 2048)
    assert geo.grid == (100, 16)
    assert geo.smem_bytes == 106496
    assert _fits(geo.smem_bytes, 2) and not _fits(geo.smem_bytes, 3)


@pytest.mark.parametrize("BH", [32, 50])
def test_flash_mesh_rank_geometry(BH):
    """A rank of the (1, 2) serving mesh: TinyLlama-1.1B's 16 query heads
    a rank (BH 32 for B=2; its 2 kv heads a rank, n_rep 8) and Hymba-1.5B's
    25 heads, whole on each rank (BH 50), over 1024 queries at d=64: 8
    query tiles of 128, the main path's two blocks an SM."""
    geo = fk.launch_geometry(64, torch.float32, BH, 1024)
    assert geo.grid == (BH, 8)
    assert geo.smem_bytes == 106496 and _fits(geo.smem_bytes, 2)


def test_flash_geometry_refuses_what_the_kernel_does_not_take():
    for d in (0, 8, 48, 96, 512):
        with pytest.raises(ValueError, match="head dim"):
            fk.launch_geometry(d)
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(TypeError):
            fk.launch_geometry(64, dtype)


@pytest.mark.parametrize("d", fk.HEAD_DIMS)
def test_flash_float16_stages_as_bfloat16(d):
    """float16 takes bfloat16's staging: the same 2-byte tiles, two of them
    (K and V in flight together), one at d = 256, where two would pass
    ``SMEM_MAX``; so the same shared bytes, tiles and grid."""
    h, bf = (fk.launch_geometry(d, dt, 100, 2048)
             for dt in (torch.float16, torch.bfloat16))
    assert h == bf
    f32 = fk.launch_geometry(d, torch.float32, 100, 2048)
    stage = fk.staging_tiles(d) * fk.K_TILE * d * 2
    assert fk.staging_tiles(d) == (1 if d == 256 else 2)
    assert h.smem_bytes == f32.smem_bytes + stage <= fk.SMEM_MAX
    if d == 256:
        assert f32.smem_bytes + 2 * fk.K_TILE * d * 2 > fk.SMEM_MAX


@pytest.mark.parametrize("Sq,Sk", [(1, 1500), (384, 1500), (1600, 1500),
                                   (37, 100), (37, 16), (1500, 1500),
                                   (2, 1)])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (False, 16), (True, 16)])
def test_flash_length_rule(Sq, Sk, causal, window):
    """Any Sq against Sk keys with no mask (cross-attention: Whisper's
    decoder against its 1500 frames, a decode step at Sq = 1); Sq <= Sk
    under a causal mask or a window.  The wrapper's ``_check`` applies this
    rule on the card; the grid covers every query tile."""
    if Sq > Sk and (causal or window):
        with pytest.raises(ValueError, match="Sq <= Sk"):
            fk.check_lengths(Sq, Sk, causal, window)
    else:
        fk.check_lengths(Sq, Sk, causal, window)
        geo = fk.launch_geometry(64, torch.float32, 64, Sq)
        assert geo.grid == (64, -(-Sq // geo.q_tile))


def test_flash_length_rule_refuses_empty_and_negative():
    for Sq, Sk, window in ((0, 10, 0), (10, 0, 0), (1, 1, -1)):
        with pytest.raises(ValueError):
            fk.check_lengths(Sq, Sk, False, window)


def test_flash_whisper_geometry():
    """Whisper-medium at B=4: 64 (batch, head) rows at d=64; the encoder's
    1500 queries make 12 tiles of 128 (the last holds 92), a 384-token
    prompt 3 and a decode step's cross-attention one tile with one live
    row; the keys' ragged last tile (1500 = 23 x 64 + 28) is masked."""
    for Sq, tiles in ((1500, 12), (384, 3), (1, 1)):
        geo = fk.launch_geometry(64, torch.float32, 64, Sq)
        assert geo.grid == (64, tiles) and geo.smem_bytes == 106496


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_geometry_at_head_dim_256(dtype):
    """Gemma-3-4B's prefill: 32 (batch, head) rows of 2048 queries at
    d=256: 64 query tiles of 32 (2 rows a thread), one block an SM.  The
    float tiles take 43,904 floats; bfloat16 and float16 add ONE staging
    tile of 64 keys, since a second would pass the 232,448 bytes a block
    may have."""
    geo = fk.launch_geometry(256, dtype, 32, 2048)
    assert geo.grid == (32, 64) and geo.q_tile == 32 and geo.rows == 2
    floats = 32 * 260 + 2 * 64 * 260 + 32 * 72
    assert floats == 43904
    stage = 64 * 256 * 2 if dtype != torch.float32 else 0
    assert geo.smem_bytes == 4 * floats + stage
    assert geo.smem_bytes == (208384 if stage else 175616) <= fk.SMEM_MAX
    assert 4 * floats + 2 * stage > fk.SMEM_MAX or not stage
    assert fk.staging_tiles(256) == 1 and fk.staging_tiles(128) == 2
    assert geo.min_blocks == 1
    assert _fits(geo.smem_bytes, 1) and not _fits(geo.smem_bytes, 2)


@pytest.mark.parametrize("p_lo", range(1, sk.MAX_PN + 1, 16))
def test_ssd_geometry_within_the_card_limits(p_lo):
    """Every P in [p_lo, p_lo + 16), every N in [1, 128], every chunk in
    [1, 128]."""
    for P in range(p_lo, p_lo + 16):
        for N in range(1, sk.MAX_PN + 1):
            for Q in range(1, sk.MAX_CHUNK + 1):
                geo = sk.launch_geometry(P, N, Q)
                assert geo.threads == sk.THREADS <= 1024
                assert geo.state_threads == sk.STATE_THREADS <= 1024
                assert geo.pass_threads == sk.PASS_THREADS <= 1024
                # the chunk state pass: two halves of 128 threads, one
                # (2 p x 4 n) tile each at a time
                assert geo.state_threads == 2 * geo.threads
                assert geo.chunk_pad % 32 == 0
                assert Q <= geo.chunk_pad < Q + 32
                assert geo.chunk_pad <= 4 * 32     # warp 0's scan: 4 a lane
                # the x tile (chunk x 64) and the B / C rows each block holds
                qp = geo.chunk_pad
                assert geo.state_smem >= 4 * qp * (sk.P_TILE + N)
                assert geo.scan_smem >= 4 * qp * (sk.P_TILE + 2 * N)
                assert 0 < geo.state_smem <= sk.SMEM_MAX
                assert 0 < geo.scan_smem <= sk.SMEM_MAX
                assert geo.state_smem % 16 == 0 and geo.scan_smem % 16 == 0
                (b1, p1), (b2, _), (b3, p3) = geo.grids
                assert p1 == p3 == -(-P // sk.P_TILE) <= 2
                assert p1 * sk.P_TILE >= P
                assert b1 == b3 == -(-1 // Q) and b2 >= 1


@pytest.mark.parametrize("b,h,s,chunk", [(4, 50, 2048, 128), (4, 50, 2112, 64),
                                         (1, 1, 1, 1), (16, 128, 2 ** 18, 1)])
def test_ssd_grids_within_their_limits(b, h, s, chunk):
    geo = sk.launch_geometry(64, 16, chunk, b, h, s)
    (b1, p1), (b2, p2), (b3, p3) = geo.grids
    n_chunks = -(-s // chunk)
    assert b1 == b3 == b * h * n_chunks <= sk.GRID_X_MAX
    assert b2 * sk.PASS_THREADS >= b * h * 64 * 16 > (b2 - 1) * sk.PASS_THREADS
    assert max(p1, p2, p3) <= sk.GRID_Y_MAX


def test_ssd_main_path_geometry():
    """Hymba-1.5B's prefill: 3,200 blocks for each chunk pass (16 chunks of
    200 (batch, head) pairs), and three chunk scan blocks an SM."""
    geo = sk.launch_geometry(64, 16, 128, 4, 50, 2048)
    assert geo.grids == ((3200, 1), (800, 1), (3200, 1))
    assert geo.scan_smem == 71680 and geo.state_smem == 46592
    assert _fits(geo.scan_smem, 3) and _fits(geo.state_smem, 4)


def test_ssd_mesh_rank_geometry():
    """A rank of the (1, 2) serving mesh: Hymba-1.5B's 25 of 50 SSM heads
    a rank, B=2 x 1024 tokens: 400 blocks for each chunk pass (8 chunks of
    50 (batch, head) pairs), the main path's shared memory."""
    geo = sk.launch_geometry(64, 16, 128, 2, 25, 1024)
    assert geo.grids == ((400, 1), (200, 1), (400, 1))
    assert geo.scan_smem == 71680 and geo.state_smem == 46592


def test_ssd_geometry_refuses_what_the_kernel_does_not_take():
    for P, N in ((0, 16), (129, 16), (64, 0), (64, 129)):
        with pytest.raises(ValueError, match="head dim"):
            sk.launch_geometry(P, N, 128)
    for chunk in (0, 129, 256):
        with pytest.raises(ValueError, match="chunk"):
            sk.launch_geometry(64, 16, chunk)

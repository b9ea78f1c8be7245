"""Port: the roofline model (``launch.roofline``) against the reference's.

``model_flops`` is the reference's formula (6·N·D for train, 2·N_active a
token otherwise) and must equal it exactly for every arch x shape cell;
``analyze`` keeps the reference's terms with the H100's published figures
in place of the TPU's, which each term is held to by hand.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs.base import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch, shape):
    assert roofline.model_flops(tget(arch), TSHAPES[shape]) == (
        jroofline.model_flops(jget(arch), SHAPES[shape]))


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989.4e12
    assert roofline.FP32_FLOPS == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    assert roofline.NET_BW == 50e9
    assert roofline.peak_flops(torch.float32) == 67e12
    assert roofline.peak_flops(torch.bfloat16) == 989.4e12
    # a model group of 16 consecutive ranks spans two 8-GPU nodes
    assert roofline.link_bw(range(8)) == 450e9
    assert roofline.link_bw(range(16)) == 50e9
    assert roofline.link_bw(range(0, 256, 16)) == 50e9


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_analyze_terms_by_hand(dtype):
    cfg, shape = tget("tinyllama_1_1b"), TSHAPES["train_4k"]
    flops, hbm, coll = 5.0e13, 3.0e12, 1.0e10
    rl = roofline.analyze(cfg, shape, 256, flops, hbm, coll, dtype=dtype)
    peak = 67e12 if dtype == torch.float32 else 989.4e12
    assert rl.compute_s == flops / peak
    assert rl.memory_s == hbm / 3.35e12
    assert rl.collective_s == coll / 50e9
    mf = 6.0 * cfg.param_counts()["active"] * 256 * 4096
    assert rl.model_flops == mf
    assert rl.useful_ratio == mf / (flops * 256)
    assert rl.bound_s == max(flops / peak, hbm / 3.35e12, coll / 50e9)
    assert rl.dominant == "memory"
    assert rl.roofline_fraction == (mf / (256 * peak)) / rl.bound_s
    within = roofline.analyze(cfg, shape, 8, flops, hbm, coll,
                              coll_bw=roofline.link_bw(range(8)))
    assert within.collective_s == coll / 450e9

"""Port parity: the segment_combine kernel layer.

The port's plain ``segment_combine_blocks`` (the version CPU tensors take)
is held against the reference's pure-jnp ``segment_combine_blocks_ref``
and against the reference's Pallas kernel run in interpret mode, over
op x dtype x (eb, nb, rows), with -1 padding and values at the dtype's
edges.  Tolerances:

* integers and min/max: bitwise;
* float32 sums: rtol=1e-6 (the three sum the lanes in different orders);
* bfloat16/float16 sums: bitwise against the Pallas kernel, which, like
  the port, accumulates in float32 and rounds once; against ``ref.py``,
  which accumulates in the storage dtype and rounds at every add,
  rtol=3e-2 (bf16) / 5e-3 (f16), about four times the largest error seen
  on these inputs.

The CUDA kernel itself runs only on a card: its tests are in
``test_torch_cuda.py``, which imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_combine import ops as ref_ops  # noqa: E402
from repro.kernels.segment_combine.kernel import (  # noqa: E402
    segment_combine_blocks as pallas_blocks)
from repro.kernels.segment_combine.ref import (  # noqa: E402
    segment_combine_blocks_ref as jnp_blocks)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels.segment_combine import kernel as tkernel  # noqa: E402
from repro_torch.kernels.segment_combine import ops as tops  # noqa: E402
from repro_torch.kernels.segment_combine.ref import (  # noqa: E402
    segment_combine_blocks_ref as torch_blocks, sentinels)

DTYPES = {"int32": (jnp.int32, torch.int32),
          "float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
SHAPES = [(8, 32, 7), (64, 128, 5), (512, 32, 3)]     # (eb, nb, rows)
SUM_RTOL_VS_REF = {"bfloat16": 3e-2, "float16": 5e-3}


def _inputs(op, dtype, eb, nb, rows, seed=0):
    """Packed values (float32 or int32 numpy) and -1-padded indices."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, nb, (rows, eb)).astype(np.int32)
    if dtype == "int32":
        info = np.iinfo(np.int32)
        vals = rng.randint(info.min, info.max, (rows, eb),
                           dtype=np.int64).astype(np.int32)
        vals.reshape(-1)[:4] = [info.min, info.max, info.min + 1, -1]
    elif op == "sum":
        vals = (rng.rand(rows, eb) + 0.5).astype(np.float32)
    else:
        vals = rng.randn(rows, eb).astype(np.float32)
        vals.reshape(-1)[:2] = [np.inf, -np.inf]
    return vals, idx


def _as_f64(x):
    x = x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32)
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("eb,nb,rows", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_plain_blocks_match_reference_and_pallas(op, dtype, eb, nb, rows):
    vals, idx = _inputs(op, dtype, eb, nb, rows)
    jdt, tdt = DTYPES[dtype]
    vj = jnp.asarray(vals).astype(jdt)
    # the same (already rounded) values on both sides
    vt = torch.from_numpy(np.array(vj.astype(jnp.float32))).to(tdt) \
        if dtype != "int32" else torch.from_numpy(vals)
    got = torch_blocks(vt, torch.from_numpy(idx), op, nb)
    assert got.dtype == tdt and got.shape == (rows, nb)
    pal = pallas_blocks(vj, jnp.asarray(idx), op, nb, interpret=True)
    ref = jnp_blocks(vj, jnp.asarray(idx), op, nb)
    g, p, r = _as_f64(got), _as_f64(pal), _as_f64(ref)
    if op != "sum" or dtype == "int32":
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, r)
    elif dtype == "float32":
        np.testing.assert_allclose(g, p, rtol=1e-6)
        np.testing.assert_allclose(g, r, rtol=1e-6)
    else:
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, r, rtol=SUM_RTOL_VS_REF[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sentinels_match_reference(dtype):
    from repro.kernels.segment_combine.kernel import sentinels as ref_sent
    jdt, tdt = DTYPES[dtype]
    assert sentinels(tdt) == tuple(float(s) if dtype != "int32" else s
                                   for s in ref_sent(jdt))


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_pack_and_segment_combine_equal(op):
    """pack_edges / pack_values / segment_combine against the reference,
    int32 ids above 2^24 included (they must survive exactly)."""
    rng = np.random.RandomState(7)
    N, E = 300, 1200
    dst = rng.randint(0, N, E)
    vals = rng.randint(2 ** 24 - 2, 2 ** 24 + 50, E).astype(np.int32)
    order_r, idx_r = ref_ops.pack_edges(dst, N, nb=128, eb_align=128)
    order_t, idx_t = tops.pack_edges(dst, N, nb=128, eb_align=128)
    np.testing.assert_array_equal(order_t, order_r)
    np.testing.assert_array_equal(idx_t, idx_r)
    pv_r = ref_ops.pack_values(vals, order_r, idx_r, op)
    pv_t = tops.pack_values(vals, order_t, idx_t, op)
    assert pv_t.dtype == np.int32
    np.testing.assert_array_equal(pv_t, pv_r)
    want = np.asarray(ref_ops.segment_combine(
        jnp.asarray(pv_r), jnp.asarray(idx_r), op, 128, N))
    for use_kernel in (True, False):
        got = tops.segment_combine(torch.from_numpy(pv_t),
                                   torch.from_numpy(idx_t), op, 128, N,
                                   use_kernel=use_kernel)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    rows = np.array([2, 0], np.int64)
    sub = tops.segment_combine_rows(torch.from_numpy(pv_t),
                                    torch.from_numpy(idx_t),
                                    torch.from_numpy(rows), op, 128)
    np.testing.assert_array_equal(sub.numpy(), np.asarray(
        ref_ops.segment_combine_rows(jnp.asarray(pv_r), jnp.asarray(idx_r),
                                     jnp.asarray(rows), op, 128,
                                     use_kernel=False)))


def test_cpu_dispatch_never_builds_the_kernel(monkeypatch):
    """CPU tensors take the plain version: no nvcc, no library, no
    launch counted."""
    def boom(*a, **k):
        raise AssertionError("the CUDA kernel was built for a CPU tensor")
    monkeypatch.setattr(tkernel, "build_library", boom)
    monkeypatch.setattr(tkernel, "_library", boom)
    before = tkernel.segment_combine_blocks.launches
    vals, idx = _inputs("min", "int32", 64, 32, 4)
    out = tkernel.segment_combine_blocks(torch.from_numpy(vals),
                                         torch.from_numpy(idx), "min", 32)
    assert out.shape == (4, 32)
    out2 = tplan._combine_rows(torch.from_numpy(vals), torch.from_numpy(idx),
                               "max", 32)
    assert out2.shape == (4, 32)
    assert tkernel.segment_combine_blocks.launches == before


def test_kernel_mode_kernel_raises_on_cpu_tensors():
    vals, idx = _inputs("min", "float32", 8, 32, 2)
    try:
        tplan.set_kernel_mode("kernel")
        with pytest.raises(ValueError, match="CUDA"):
            tplan._combine_rows(torch.from_numpy(vals),
                                torch.from_numpy(idx), "min", 32)
    finally:
        tplan.set_kernel_mode("auto")
    with pytest.raises(ValueError, match="kernel mode"):
        tplan.set_kernel_mode("pallas")


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc (the tests run without the CUDA toolkit): writes
    the -o file and a ptxas-like line, and logs each call."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {tmp_path / 'calls.log'}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then shift; echo lib > \"$1\"; fi\n"
        "  shift\n"
        "done\n"
        "echo 'ptxas info    : Used 40 registers'\n")
    script.chmod(0o755)
    return str(script)


def test_build_helper_builds_each_source_once_and_again_when_it_changes(
        monkeypatch, tmp_path):
    """One nvcc a source, started together; an unchanged source is reused
    and a changed one rebuilt under a new name; the flags are the one set
    shared by every kernel."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path))
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// a\n")
    b.write_text("// b\n")
    first = _build.build_libraries([(a, "liba"), (b, "libb")])
    assert [i["built"] for i in first] == [True, True]
    assert all(i["path"].exists() for i in first)
    assert "registers" in first[0]["log"]
    calls = (tmp_path / "calls.log").read_text().splitlines()
    assert len(calls) == 2
    assert all(" ".join(_build.NVCC_FLAGS) in c for c in calls)
    again = _build.build_libraries([(a, "liba"), (b, "libb")])
    assert [i["built"] for i in again] == [False, False]
    a.write_text("// a, changed\n")
    changed = _build.build_libraries([(a, "liba"), (b, "libb")])
    assert [i["built"] for i in changed] == [True, False]
    assert changed[0]["path"] != first[0]["path"]
    assert len((tmp_path / "calls.log").read_text().splitlines()) == 3


def test_every_kernel_builds_through_the_one_helper():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.worker_count import kernel as wk
    sources = {m.SOURCE for m in (tkernel, fk, sk, wk)}
    assert sources == set(_build.CSRC.glob("*.cu"))
    assert len({m.LIB_NAME for m in (tkernel, fk, sk, wk)}) == 4

"""Parity of the port's Mamba-2 SSD against the JAX package: the SSD chunk
scan kernel's plain version (the recurrence) against the JAX kernel in
interpret mode and its references, the port's ``ssd_chunked`` (y and the
final state), ``ssd_decode_step`` and ``mamba_block`` (prefill through
each kernel mode, and decode).  Inputs are drawn with numpy from a seed
and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jssd_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSMConfig  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as tsk  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan as tssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref as tssd_ref  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

RTOL = 1e-5         # of the max |value|: float32 summation order only


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _inputs(b, s, h, p, g, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    A = (-np.exp(0.5 * rng.randn(h))).astype(np.float32)
    B = rng.randn(b, s, g, n).astype(np.float32)
    C = rng.randn(b, s, g, n).astype(np.float32)
    return x, dt, A, B, C


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 16)])
def test_ssd_plain_matches_jax_kernel_and_refs(s, chunk):
    """The recurrence (the port's plain version) against the JAX kernel in
    interpret mode and its recurrent reference (y), and against JAX's
    ``ssd_chunked`` (the final state, which JAX's reference drops)."""
    b, h, p, n = 2, 4, 8, 16
    arrs = _inputs(b, s, h, p, 1, n, seed=s)
    want_k = jssd_scan(*_j(arrs), chunk=chunk)
    want_r = jssd_scan(*_j(arrs), chunk=chunk, use_kernel=False)
    _, want_state = jssm.ssd_chunked(*_j(arrs), chunk)
    got = tssd_scan(*_t(arrs), chunk=chunk, use_kernel=False)
    routed = tssd_scan(*_t(arrs), chunk=chunk)        # CPU: the plain version
    for y in (got, routed):
        _close(y.numpy(), want_k)
        _close(y.numpy(), want_r)
    x, dt, A, B, C = arrs
    flat = [x.transpose(0, 2, 1, 3).reshape(b * h, s, p),
            dt.transpose(0, 2, 1).reshape(b * h, s),
            np.tile(A, b),
            np.repeat(B, h, axis=2).transpose(0, 2, 1, 3).reshape(b * h, s, n),
            np.repeat(C, h, axis=2).transpose(0, 2, 1, 3).reshape(b * h, s, n)]
    y_flat, state = tssd_ref(*_t(flat))
    _close(y_flat.numpy(), jssd_ref(*_j(flat)))
    _close(state.numpy().reshape(b, h, p, n), want_state)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s,chunk", [(64, 16), (41, 41)])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax(s, chunk, g, init):
    """y and the final state of ``ssd_chunked``, at a chunk multiple and at
    the JAX package's ragged rule (one chunk of length s), with groups and
    an initial state; the kernel's route (the recurrence on the CPU, any
    chunk) gives the same."""
    b, h, p, n = 2, 4, 8, 16
    arrs = _inputs(b, s, h, p, g, n, seed=s + g)
    s0 = (np.random.RandomState(9).randn(b, h, p, n).astype(np.float32)
          if init else None)
    jy, js = jssm.ssd_chunked(*_j(arrs), chunk,
                              init_state=None if s0 is None else
                              jnp.asarray(s0))
    ty, ts = tssm.ssd_chunked(*_t(arrs), chunk,
                              init_state=None if s0 is None else
                              torch.from_numpy(s0))
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)
    before = tsk.ssd_chunk_scan.launches
    ky, ks = tsk.ssd_chunk_scan(*_t(arrs), chunk=16,
                                init_state=None if s0 is None else
                                torch.from_numpy(s0))
    assert tsk.ssd_chunk_scan.launches == before
    _close(ky.numpy(), jy)
    _close(ks.numpy(), js)


def test_ssd_decode_step_matches_jax():
    b, h, p, n, g = 2, 4, 8, 16, 2
    rng = np.random.RandomState(4)
    state = rng.randn(b, h, p, n).astype(np.float32)
    x = rng.randn(b, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, h))).astype(np.float32)
    A = (-np.exp(rng.randn(h))).astype(np.float32)
    B = rng.randn(b, g, n).astype(np.float32)
    C = rng.randn(b, g, n).astype(np.float32)
    arrs = (state, x, dt, A, B, C)
    jy, js = jssm.ssd_decode_step(*_j(arrs))
    ty, ts = tssm.ssd_decode_step(*_t(arrs))
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0])
    want = jax.nn.softplus(jnp.asarray(x.numpy()))
    _close(tssm.softplus(x).numpy(), want, rtol=1e-7)


def _mamba_weights(D, di, h, g, n, width, seed):
    rng = np.random.RandomState(seed)

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[-2] if len(shape) > 1
                                            else 1)).astype(np.float32)
    return {"wz": w(D, di), "wx": w(D, di), "wB": w(D, g * n),
            "wC": w(D, g * n), "wdt": w(D, h), "conv_x": w(width, di),
            "conv_B": w(width, g * n), "conv_C": w(width, g * n),
            "A_log": np.log(np.arange(1, h + 1)).astype(np.float32),
            "D_skip": np.ones(h, np.float32),
            "dt_bias": np.full(h, np.log(np.expm1(0.01)), np.float32),
            "norm": (0.1 * rng.randn(di)).astype(np.float32),
            "out_proj": w(di, D)}


@pytest.mark.parametrize("s", [24, 21])
def test_mamba_block_prefill_and_decode_match_jax(s):
    """Prefill through each kernel mode (on the CPU "auto" and "ref" run
    ``ssd_chunked`` with the JAX chunk rule, "kernel" the scan kernel's
    wrapper, which keeps cfg.chunk with a ragged last chunk), then three
    decode steps from the prefill's conv and SSM states."""
    D, di, h, g, n, width, chunk = 32, 64, 4, 1, 8, 4, 8
    kw = dict(d_state=n, expand=2, head_dim=di // h, conv_width=width,
              n_groups=g, chunk=chunk)
    jcfg, tcfg = JSSMConfig(**kw), TSSMConfig(**kw)
    w = _mamba_weights(D, di, h, g, n, width, seed=s)
    x = np.random.RandomState(s).randn(2, s + 3, D).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    jy, (jconv, jstate) = jssm.mamba_block(jnp.asarray(x[:, :s]), jw, jcfg, D)
    for mode in ("auto", "kernel", "ref"):
        ty, (tconv, tstate) = tssm.mamba_block(torch.from_numpy(x[:, :s]), tw,
                                               tcfg, D, kernels=mode)
        _close(ty.numpy(), jy)
        _close(tstate.numpy(), jstate)
        for a, b in zip(tconv, jconv):
            _close(a.numpy(), b)
    jc, js, tc, ts = jconv, jstate, tconv, tstate
    for t in range(s, s + 3):
        jy, (jc, js) = jssm.mamba_block(jnp.asarray(x[:, t:t + 1]), jw, jcfg,
                                        D, conv_state=jc, ssm_state=js,
                                        decode=True)
        ty, (tc, ts) = tssm.mamba_block(torch.from_numpy(x[:, t:t + 1]), tw,
                                        tcfg, D, conv_state=tc, ssm_state=ts,
                                        decode=True)
        _close(ty.numpy(), jy)
        _close(ts.numpy(), js)

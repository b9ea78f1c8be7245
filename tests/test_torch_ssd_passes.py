"""The SSD chunk scan kernel's three passes in their plain PyTorch form
(``repro_torch.kernels.ssd_scan.ref``): chunk state, state passing and
chunk scan, composed, against the JAX package's kernel in interpret mode
and its recurrent reference, and against the port's recurrence at a
ragged length, with groups and an initial state; each state the passing
pass hands to a chunk against the recurrence's state at that position.
Inputs are drawn with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as tref  # noqa: E402

RTOL = 1e-5         # of the max |value|: float32 summation order only


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _inputs(b, s, h, p, g, n, seed, init=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    A = (-np.exp(0.5 * rng.randn(h))).astype(np.float32)
    B = rng.randn(b, s, g, n).astype(np.float32)
    C = rng.randn(b, s, g, n).astype(np.float32)
    s0 = rng.randn(b, h, p, n).astype(np.float32) if init else None
    return (x, dt, A, B, C), s0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32), (128, 128)])
def test_passes_match_jax_kernel_and_ref(s, chunk):
    """g=1, S a multiple of the chunk: the three passes composed give the
    JAX kernel's y (interpret mode) and its recurrent reference's."""
    arrs, _ = _inputs(2, s, 4, 8, 1, 16, seed=s + chunk)
    want_k = jssd_scan(*[jnp.asarray(a) for a in arrs], chunk=chunk)
    want_r = jssd_scan(*[jnp.asarray(a) for a in arrs], chunk=chunk,
                       use_kernel=False)
    y, _ = tref.ssd_scan_chunked_ref(*_t(arrs), chunk=chunk)
    _close(y.numpy(), want_k)
    _close(y.numpy(), want_r)


@pytest.mark.parametrize("s,chunk", [(45, 16), (64, 16), (37, 128), (130, 64)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("init", [False, True])
def test_passes_match_the_recurrence(s, chunk, g, init):
    """Ragged and chunk-multiple S, groups, an initial state: y and the
    final state of the composed passes against the port's recurrence."""
    arrs, s0 = _inputs(2, s, 4, 8, g, 16, seed=s + 3 * g, init=init)
    init_t = None if s0 is None else torch.from_numpy(s0)
    want_y, want_s = tref.ssd_scan_ref_model(*_t(arrs), init_t)
    y, state = tref.ssd_scan_chunked_ref(*_t(arrs), init_t, chunk=chunk)
    _close(y.numpy(), want_y.numpy())
    _close(state.numpy(), want_s.numpy())


@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16)])
@pytest.mark.parametrize("init", [False, True])
def test_entering_states_are_the_recurrence_states(s, chunk, init):
    """The state the passing pass hands to chunk c is the recurrence's
    state after the first c chunks' positions (the initial state for
    c = 0); each chunk's own contribution is the recurrence over that
    chunk alone from zero, and its decay exp(sum dt A)."""
    arrs, s0 = _inputs(2, s, 4, 8, 2, 16, seed=s + 11, init=init)
    x, dt, A, B, C = _t(arrs)
    init_t = None if s0 is None else torch.from_numpy(s0)
    states, decay = tref.ssd_chunk_state_ref(x, dt, A, B, chunk=chunk)
    entering, final = tref.ssd_state_passing_ref(states, decay, init_t)
    nc = -(-s // chunk)
    assert states.shape == entering.shape == (2, 4, nc, 8, 16)
    assert decay.shape == (2, 4, nc)
    for c in range(nc):
        end = c * chunk
        if end == 0:
            want = (torch.zeros_like(final) if init_t is None else init_t)
        else:
            want = tref.ssd_scan_ref_model(x[:, :end], dt[:, :end], A,
                                           B[:, :end], C[:, :end],
                                           init_t)[1]
        _close(entering[:, :, c].numpy(), want.numpy())
        lo, hi = c * chunk, min(s, (c + 1) * chunk)
        own = tref.ssd_scan_ref_model(x[:, lo:hi], dt[:, lo:hi], A,
                                      B[:, lo:hi], C[:, lo:hi])[1]
        _close(states[:, :, c].numpy(), own.numpy())
        want_decay = torch.exp((dt[:, lo:hi] * A).sum(dim=1))
        _close(decay[:, :, c].numpy(), want_decay.numpy())
    _close(final.numpy(), tref.ssd_scan_ref_model(x, dt, A, B, C,
                                                  init_t)[1].numpy())


def test_passes_keep_float64_for_an_oracle():
    arrs, s0 = _inputs(1, 40, 2, 4, 1, 8, seed=5, init=True)
    args = [t.double() for t in _t(arrs)]
    y, state = tref.ssd_scan_chunked_ref(*args, torch.from_numpy(s0).double(),
                                         chunk=16)
    assert y.dtype == state.dtype == torch.float64
    want_y, want_s = tref.ssd_scan_ref_model(*args,
                                             torch.from_numpy(s0).double())
    _close(y.numpy(), want_y.numpy(), rtol=1e-12)
    _close(state.numpy(), want_s.numpy(), rtol=1e-12)

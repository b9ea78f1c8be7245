"""Port: ``repro_torch.models.moe`` and ``moe_mirror_threshold`` against the
JAX package on the CPU.

The same inputs, drawn with numpy from a seed, go through the reference's
function and the port's.  Routing is discontinuous, so the chosen experts
must be EQUAL, not close: ``torch.topk`` and ``lax.top_k`` agree on
distinct values only, and every seed here gives router probabilities with
no exact tie within a row (asserted by ``_no_ties``).

Tolerances (float32): router probabilities and gates within rtol 1e-6;
``buf``, ``buf_gate``, ``buf_tok`` and the kept (token, expert) pairs
bitwise (copies, when both sides pack the same routing); ``_unpack``'s
sum of up to k gated rows and ``moe_ffn_ref``'s output within 1e-5 of
max|y| (a few float32 ulps of the products, summed over k terms); the
aux loss within rtol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

PROB_RTOL = 1e-6
Y_RTOL = 1e-5
AUX_RTOL = 1e-6


def _weights(seed, E, D, F, n_m=1):
    rng = np.random.RandomState(seed)
    s = np.float32(0.1)
    shapes = {"router": (D, E), "w_gate": (E, D, F), "w_up": (E, D, F),
              "w_down": (E, F, D), "w_gate_m": (n_m, D, F),
              "w_up_m": (n_m, D, F), "w_down_m": (n_m, F, D)}
    return {k: (rng.randn(*v).astype(np.float32) * s)
            for k, v in sorted(shapes.items())}


def _x(seed, T, D):
    return np.random.RandomState(seed + 100).randn(T, D).astype(np.float32)


def _no_ties(probs):
    p = np.sort(np.asarray(probs), axis=-1)
    assert (np.diff(p, axis=-1) > 0).all(), "a router tie: pick another seed"


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize("T,E,k", [(37, 4, 1), (37, 4, 2), (64, 8, 2),
                                   (50, 6, 3)])
def test_router_probs_and_load_balance_loss(T, E, k):
    D = 16
    w = _weights(T + E, E, D, 32)
    x = _x(T, T, D)
    jg, ji, jp = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w["router"]),
                                   k)
    tg, ti, tp = tmoe.router_probs(torch.from_numpy(x),
                                   torch.from_numpy(w["router"]), k)
    _no_ties(jp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=PROB_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=PROB_RTOL)
    assert tg.dtype == torch.float32
    want = float(jmoe.load_balance_loss(jp, ji, E))
    got = float(tmoe.load_balance_loss(tp, ti, E))
    assert abs(got - want) <= AUX_RTOL * abs(want)


def _kept_pairs(buf_tok, idx, E):
    """{(token, expert)} of the occupied slots of a (E, C) buf_tok."""
    bt = np.asarray(buf_tok)
    return {(int(bt[e, c]), e) for e in range(E) for c in range(bt.shape[1])
            if bt[e, c] >= 0}


@pytest.mark.parametrize("cap", [1, 5, 40])
@pytest.mark.parametrize("n_m", [0, 2])
def test_pack_and_unpack_match_jax(cap, n_m):
    T, D, E, k = 29, 8, 6, 2
    w = _weights(7, E, D, 16)
    x = _x(7, T, D)
    jg, ji, jp = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w["router"]),
                                   k)
    _no_ties(jp)
    mirrored = np.arange(E) < n_m
    jbuf, jbg, jbt = jmoe._pack(jnp.asarray(x), ji, jg, E, cap,
                                jnp.asarray(mirrored))
    # the reference's routing on both sides, so that the packs are copies
    tx = torch.from_numpy(x)
    tg = torch.from_numpy(np.array(jg))
    ti = torch.from_numpy(np.array(ji)).long()
    tbuf, tbg, tbt = tmoe._pack(tx, ti, tg, E, cap,
                                torch.from_numpy(mirrored))
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tbg.numpy(), np.asarray(jbg))
    # the keep mask: the port's kept pairs are the reference's occupied slots
    _, _, send, keep = tmoe._slots(ti, E, cap, torch.from_numpy(mirrored))
    kept = keep.numpy().reshape(T, k)
    assert {(t, int(ti[t, j])) for t in range(T) for j in range(k)
            if kept[t, j]} == _kept_pairs(jbt, ji, E)
    assert not send.numpy().reshape(T, k)[np.isin(np.asarray(ji),
                                                  np.arange(n_m))].any()
    # the receiver-side combine on the same expert outputs
    y_buf = np.random.RandomState(1).randn(E, cap, D).astype(np.float32)
    want = jmoe._unpack(jnp.asarray(y_buf), jbg, jbt, T, D)
    got = tmoe._unpack(torch.from_numpy(y_buf), tbg, tbt, T, D)
    assert _rel(got.numpy(), want) <= Y_RTOL


@pytest.mark.parametrize("cf", [0.25, 1.25, 50.0])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("T", [37, 64])
def test_moe_ffn_ref_matches_jax(cf, k, T):
    """Drops at capacity factor 0.25 (and some at 1.25), none at 50; T=37
    is not a multiple of E=4."""
    D, E, F = 16, 4, 32
    w = _weights(3, E, D, F)
    x = _x(11, T, D)
    jcfg = JMoE(n_experts=E, top_k=k, d_ff_expert=F, capacity_factor=cf)
    tcfg = TMoE(**dataclasses.asdict(jcfg))
    jy, jaux = jmoe.moe_ffn_ref(jnp.asarray(x), _jax(w), jcfg)
    tmoe.record = []
    try:
        ty, taux = tmoe.moe_ffn_ref(torch.from_numpy(x), _torch(w), tcfg)
        rec, = tmoe.record
    finally:
        tmoe.record = None
    # the same experts chosen and kept
    jg, ji, jp = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w["router"]),
                                   k)
    _no_ties(jp)
    _, ti, _ = tmoe.router_probs(torch.from_numpy(x),
                                 torch.from_numpy(w["router"]), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    cap = max(1, int(cf * T * k / E))
    assert rec["cap"] == cap and rec["rows"] == E * cap
    assert rec["pairs"] == T * k and int(rec["sent"]) == T * k
    _, _, jbt = jmoe._pack(jnp.asarray(x), ji, jg, E, cap,
                           jnp.zeros((E,), bool))
    want_kept = _kept_pairs(jbt, ji, E)
    assert int(rec["occupied"]) == len(want_kept) == int(rec["kept"].sum())
    np.testing.assert_array_equal(
        rec["load"].numpy(), np.bincount(np.asarray(ji).reshape(-1),
                                         minlength=E))
    if cf == 0.25:
        assert len(want_kept) < T * k          # tokens were dropped
    if cf == 50.0:
        assert len(want_kept) == T * k
    assert _rel(ty.numpy(), jy) <= Y_RTOL
    assert abs(float(taux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))


def test_moe_ffn_ref_no_drop_equals_dense_mix():
    """With a huge capacity, the dispatch equals the per-token top-k mix
    computed in float64 (the reference's own test, on the port)."""
    T, D, E, F, k = 24, 16, 4, 32, 2
    w = _weights(0, E, D, F)
    x = _x(1, T, D)
    cfg = TMoE(n_experts=E, top_k=k, d_ff_expert=F, capacity_factor=50.0)
    y, aux = tmoe.moe_ffn_ref(torch.from_numpy(x), _torch(w), cfg)
    gates, idx, _ = tmoe.router_probs(torch.from_numpy(x),
                                      torch.from_numpy(w["router"]), k)
    w64 = {n: torch.from_numpy(v).double() for n, v in w.items()}
    want = torch.zeros(T, D, dtype=torch.float64)
    for t in range(T):
        for j in range(k):
            e = int(idx[t, j])
            want[t] += tmoe._expert_mlp(
                torch.from_numpy(x[t:t + 1]).double(), w64["w_gate"][e],
                w64["w_up"][e], w64["w_down"][e])[0] * float(gates[t, j])
    assert _rel(y.numpy(), want.numpy()) <= Y_RTOL
    assert float(aux) > 0


@pytest.mark.parametrize("tokens", [1, 512, 8192])
@pytest.mark.parametrize("ep", [2, 4, 16])
@pytest.mark.parametrize("steps", [1, 100])
@pytest.mark.parametrize("fpb", [240.0, 20.0])
def test_moe_mirror_threshold_matches_jax(tokens, ep, steps, fpb):
    args = (tokens, ep, 2048, 1024)
    want = jcm.moe_mirror_threshold(*args, steps_between_rebalance=steps,
                                    flops_per_byte=fpb)
    assert tcm.moe_mirror_threshold(
        *args, steps_between_rebalance=steps, flops_per_byte=fpb) == want
    assert tcm.moe_mirror_threshold(*args) == jcm.moe_mirror_threshold(*args)

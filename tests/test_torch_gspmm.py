"""Port parity: gSpMM joins, their gradients, the embedding and optimizer
helpers and GCN training, against the reference.

The single-device cases of ``tests/test_gspmm.py`` (the sharded subprocess
case waits for the sharded executor), with the reference as the oracle on
the same partition and the same inputs.  Tolerances:

* forward sums: rtol=1e-5 (the reference's own against its dense scatter);
* gradients: rtol=1e-4 against the reference's ``jax.grad`` (the
  reference's own bound for its custom VJP);
* max kinds: bitwise; message stats: exact;
* ``softmax_xent`` and ``adamw_update``: rtol=1e-6 (one float32 rounding
  order apart); ``node_embedding_init`` and the other numpy-drawn inits:
  array-equal;
* GCN loss histories: rtol=1e-4 over the epochs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import EngineConfig as RefConfig  # noqa: E402
from repro.core import gspmm as rgspmm  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro.models import embedding as remb  # noqa: E402
from repro.train import gcn as rgcn  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch.api import Engine, EngineConfig  # noqa: E402
from repro_torch.core import channels as tch  # noqa: E402
from repro_torch.core import gspmm as tgspmm  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph import structs as tstructs  # noqa: E402
from repro_torch.models import embedding as temb  # noqa: E402
from repro_torch.train import gcn as tgcn  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from test_torch_graph import same_partition, to_np  # noqa: E402

F = 5
KINDS = [("copy_u_sum", False), ("u_mul_e_sum", True)]


def _setup(layout):
    g = ref_gen.powerlaw(150, avg_deg=4, seed=2, weighted=True).symmetrized()
    pg_ref, pg_t = same_partition(g, 8, tau=8, seed=0, layout=layout)
    rng = np.random.RandomState(9)
    x = rng.randn(pg_t.M, pg_t.n_loc, F).astype(np.float32)
    cot = rng.randn(pg_t.M, pg_t.n_loc, F).astype(np.float32)
    return g, pg_ref, pg_t, x, cot


def _dense(g, pg, x, weighted):
    """sum_{(u,v)} x[u] (* w) in float64 numpy on the partition's ids."""
    src, dst = pg.perm[g.src], pg.perm[g.dst]
    xf = x.reshape(pg.n_pad, -1).astype(np.float64)
    contrib = xf[src] * (g.weight[:, None] if weighted else 1.0)
    out = np.zeros_like(xf)
    np.add.at(out, dst, contrib)
    return out.reshape(x.shape)


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("kind,weighted", KINDS)
def test_forward_vs_reference_and_dense(layout, backend, kind, weighted):
    g, pg_ref, pg_t, x, _ = _setup(layout)
    want = rgspmm.gspmm_join(pg_ref, kind, backend=backend)(jnp.asarray(x))
    got = tgspmm.gspmm_join(pg_t, kind, backend=backend)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _dense(g, pg_t, x, weighted),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("kind,weighted", KINDS)
def test_custom_vjp_vs_reference_grad(layout, backend, kind, weighted):
    """The self-adjoint backward join equals the reference's custom-VJP
    gradient (``jax.grad``) and A^T (W * g) in float64."""
    g, pg_ref, pg_t, x, cot = _setup(layout)
    fr = rgspmm.gspmm_join(pg_ref, kind, backend=backend)
    want = jax.grad(lambda z: jnp.sum(fr(z) * jnp.asarray(cot)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = tgspmm.gspmm_join(pg_t, kind, backend=backend)
    (got,) = torch.autograd.grad(torch.sum(ft(xt) * torch.from_numpy(cot)),
                                 [xt])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _dense(g, pg_t, cot, weighted),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_u_mul_e_max_zero_fill(layout, backend):
    """Forward-only max kind: bitwise the reference's, empty inboxes
    zero-filled, no gradient."""
    _, pg_ref, pg_t, x, _ = _setup(layout)
    want = rgspmm.gspmm_join(pg_ref, "u_mul_e_max",
                             backend=backend)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tgspmm.gspmm_join(pg_t, "u_mul_e_max", backend=backend)(xt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all() and not got.requires_grad
    np.testing.assert_array_equal(tgspmm.u_mul_e_max(pg_t, xt).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("kind", tgspmm.GSPMM_KINDS)
def test_gspmm_stats_accounting(layout, backend, kind):
    """The join's stats equal the reference's and the scalar broadcast's of
    the same activity, integer for integer."""
    _, pg_ref, pg_t, x, _ = _setup(layout)
    out_r, sr = rgspmm.gspmm_stats(pg_ref, kind, jnp.asarray(x),
                                   backend=backend)
    out_t, st = tgspmm.gspmm_stats(pg_t, kind, torch.from_numpy(x),
                                   backend=backend)
    assert tuple(out_t.shape) == x.shape and int(st["msgs_total"]) > 0
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_r), rtol=1e-5,
                               atol=1e-5)
    op = "max" if kind == "u_mul_e_max" else "sum"
    _, ss = tch.broadcast(pg_t, torch.from_numpy(x[:, :, 0]),
                          torch.ones(x.shape[:2], dtype=torch.bool), op,
                          relay="mul_w", backend=backend)
    assert set(st) == set(sr) == set(ss)
    for k in sr:
        np.testing.assert_array_equal(to_np(st[k]).astype(np.int64),
                                      to_np(sr[k]).astype(np.int64), k)
        np.testing.assert_array_equal(to_np(st[k]), to_np(ss[k]), k)


def test_convenience_entry_points_and_unknown_kind():
    g, _, pg_t, x, _ = _setup("csr")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tgspmm.copy_u_sum(pg_t, xt).numpy(),
                               _dense(g, pg_t, x, False), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tgspmm.u_mul_e_sum(pg_t, xt).numpy(),
                               _dense(g, pg_t, x, True), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tgspmm.gspmm_join(pg_t, "u_div_e_mean")
    # the sharded join runs over a process group of world size 2
    with pytest.raises(RuntimeError, match="world_size=2"):
        tgspmm.gspmm_sharded(pg_t, "u_mul_e_sum", xt, devices=2)


# ---------------------------------------------------------------------------
# embedding, loss, optimizer
# ---------------------------------------------------------------------------

def test_node_embedding_init_array_equal():
    _, pg_ref, pg_t, _, _ = _setup("csr")
    for seed, scale in [(3, None), (0, 0.5)]:
        want = remb.node_embedding_init(pg_ref, 6, seed=seed, scale=scale)
        got = temb.node_embedding_init(pg_t, 6, seed=seed, scale=scale)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_softmax_xent_equal():
    rng = np.random.RandomState(1)
    logits = (rng.randn(3, 7, 11) * 4).astype(np.float32)
    labels = rng.randint(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.rand(3, 7) > 0.3).astype(np.float32)
    want = remb.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                             jnp.asarray(mask))
    got = temb.softmax_xent(torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_update_equal():
    """Three AdamW steps from the same params and grads, with warm-up,
    cosine decay, weight decay and clipping all active."""
    rng = np.random.RandomState(2)
    shapes = {"W": (4, 3), "b": (3,), "emb": (2, 5, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cfg_r = ropt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                           clip_norm=0.5)
    cfg_t = topt.OptConfig(**{f: getattr(cfg_r, f)
                              for f in cfg_r.__dataclass_fields__})
    pr = {k: jnp.asarray(v) for k, v in params.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt_r, opt_t = ropt.init_opt_state(pr), topt.init_opt_state(pt)
    for _ in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        pr, opt_r, mr = ropt.adamw_update(
            pr, {k: jnp.asarray(v) for k, v in grads.items()}, opt_r, cfg_r)
        pt, opt_t, mt = topt.adamw_update(
            pt, {k: torch.from_numpy(v) for k, v in grads.items()}, opt_t,
            cfg_t)
        for k in shapes:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pr[k]),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(mt["lr"]), float(mr["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=1e-6)
    assert int(opt_t["step"]) == int(opt_r["step"]) == 3
    np.testing.assert_allclose(
        float(topt.global_norm({k: torch.from_numpy(v)
                                for k, v in params.items()})),
        float(ropt.global_norm({k: jnp.asarray(v)
                                for k, v in params.items()})), rtol=1e-6)


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def _gcn_pgs(layout, n=400, M=4):
    g = rgcn.normalize_adjacency(
        ref_gen.powerlaw(n, avg_deg=6, seed=3).symmetrized())
    return g, same_partition(g, M, tau=8, seed=0, layout=layout)


def test_gcn_helpers_equal():
    g_ref, (pg_ref, pg_t) = _gcn_pgs("csr")
    g_t = tgcn.normalize_adjacency(
        tgen.powerlaw(400, avg_deg=6, seed=3).symmetrized())
    np.testing.assert_array_equal(g_t.weight, g_ref.weight)
    np.testing.assert_array_equal(g_t.src, g_ref.src)
    lab_r, mask_r = rgcn.gcn_labels(pg_ref, 5, seed=1)
    lab_t, mask_t = tgcn.gcn_labels(pg_t, 5, seed=1)
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_r))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_r))
    pr = rgcn.init_gcn_params(pg_ref, 6, 10, 5, seed=2)
    pt = tgcn.init_gcn_params(pg_t, 6, 10, 5, seed=2)
    assert list(pt) == list(pr)
    for k in pr:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pr[k]), k)


@pytest.mark.parametrize("layout", ["padded", "csr"])
@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_gcn_loss_history_matches_reference(layout, backend):
    """Engine.run("gcn") against repro.train.gcn.run (devices=None) from
    the same params: the loss history within rtol=1e-4."""
    _, (pg_ref, pg_t) = _gcn_pgs(layout)
    kw = dict(feat_dim=16, hidden=32, n_classes=4, epochs=4, lr=5e-2)
    params = rgcn.init_gcn_params(pg_ref, 16, 32, 4, seed=0)
    want = rgcn.run(pg_ref, RefConfig(backend=backend, layout=layout),
                    params=params, **kw)
    p0 = tgcn.params_from_numpy({k: np.asarray(v)
                                 for k, v in params.items()}, "cpu")
    got = Engine(backend=backend, layout=layout, device="cpu").run(
        "gcn", pg_t, params=p0, **kw)
    assert got.n_supersteps == 4 and got.stats == {}
    np.testing.assert_allclose(got.history, want.history, rtol=1e-4)
    assert got.history[-1] < got.history[0]


def test_gcn_trains_and_loss_decreases():
    g = tgcn.normalize_adjacency(
        tgen.powerlaw(300, avg_deg=6, seed=3).symmetrized())
    pg = tstructs.partition(g, 8, tau=8, seed=0, layout="csr",
                            device="cpu")
    _, losses = tgcn.train_gcn(pg, feat_dim=16, hidden=32, n_classes=4,
                               epochs=6, lr=5e-2, seed=0, backend="pallas")
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.05, losses


def test_gcn_layout_independent():
    """Loss history is a function of the graph, not the partition layout
    (embedding init and labels are placed through pg.perm)."""
    g = tgcn.normalize_adjacency(
        tgen.powerlaw(200, avg_deg=5, seed=4).symmetrized())
    hist = {}
    for layout in ("csr", "padded"):
        pg = tstructs.partition(g, 8, tau=8, seed=0, layout=layout,
                                device="cpu")
        _, hist[layout] = tgcn.train_gcn(pg, feat_dim=8, hidden=16,
                                         n_classes=4, epochs=3, lr=3e-2,
                                         seed=0)
    np.testing.assert_allclose(hist["csr"], hist["padded"], rtol=1e-5,
                               atol=1e-6)


def test_gcn_sharded_and_pipelined_raise():
    """``devices=2`` without a process group of two ranks raises what the
    algorithms raise; ``pipeline`` acts only under ``devices``, so on its
    own it trains as one device does."""
    _, (_, pg_t) = _gcn_pgs("csr", n=100)
    with pytest.raises(RuntimeError, match="world_size=2"):
        tgcn.train_gcn(pg_t, epochs=1, devices=2)
    kw = dict(feat_dim=8, hidden=16, n_classes=4, epochs=2)
    piped = tgcn.run(pg_t, EngineConfig(pipeline=True), **kw)
    one = tgcn.run(pg_t, EngineConfig(), **kw)
    assert piped.history == one.history and piped.sharded is None
    for k, v in one.state.items():
        assert torch.equal(piped.state[k], v), k

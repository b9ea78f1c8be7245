"""The port's train step against the JAX package: ``adamw_update`` on a
nested tree, ``make_train_step`` (1 and 3 steps; 1 and 2 microbatches)
against the reference's jitted step from the same train state (carried
across with ``state_from_reference``), per leaf of params, master, m and
v; tied embeddings updated as two leaves; the GCN's optimizer results
unchanged bit for bit; the serve step factories.

Tolerances.  ``adamw_update`` on the same tree and gradients repeats the
reference's float32 arithmetic leaf by leaf: within 2 ulps (rtol 2.4e-7
of each leaf's max) and the grad norm within rtol 1e-6 (its sum runs
over the leaves in another association).  A train step's loss within
rtol 1e-5 and grad norm within rtol 1e-3 (the gradients' float32 order,
``test_torch_train.py``; measured 1.7e-4 on Gemma's first step), m
within 3e-3 and v within 6e-3 of their leaf's max (the gradient's
tolerance, doubled for a square; measured 1.0e-3), the learning rate
within rtol 1e-6 (the cosine in float32 on either side: 1 ulp seen).
params and master:
AdamW's first steps divide each gradient by its own size, so an entry
whose gradient is float32 noise (where a softmax saturates) moves by
+-lr on either side at random: each of k steps may move an entry up to
4 lr apart (|update| <= 2), plus 1e-6 of the leaf's max; the steps run
at lr = 1e-5 so that the two runs stay on one trajectory (measured
2.8e-6 after 3 steps, bound 1.2e-4).  That bound alone would pass a step
that moved nothing, so each leaf's change from the start (new - old) is
also held to the reference's change in norm: within STEP_RTOL = 0.1 of
its norm (measured at most 0.027, on the first step of Whisper's encoder
attention; a step that moves nothing is 1 off, a flipped sign 2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.transformer import ModelContext as JCtx  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from test_torch_train import (batch_np, cfgs, close_per_leaf,  # noqa: E402
                              flat_np, flat_torch, state_from_reference,
                              to_torch)

LR = 1e-5
STEPS = 3
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-3
M_RTOL, V_RTOL = 3e-3, 6e-3
UPDATE_MAX = 2.0
STEP_RTOL = 0.1
OPT_ULPS = 2 * 2.0 ** -23


def opt_cfgs(**kw):
    kw = dict(dict(lr=LR, warmup_steps=1, total_steps=10), **kw)
    return jopt.OptConfig(**kw), topt.OptConfig(**kw)


def check_states(got, want, k, start):
    """Per leaf of params, master, m and v after k steps from the JAX
    state ``start`` (the port's start carries it bit for bit)."""
    t, j, s0 = flat_torch(got), flat_np(want), flat_np(start)
    assert set(t) == set(j), set(t) ^ set(j)
    assert int(t["['opt']['step']"]) == int(j["['opt']['step']"]) == k
    for part, rtol, atol in (("['opt']['m']", M_RTOL, 0.0),
                             ("['opt']['v']", V_RTOL, 0.0)):
        close_per_leaf({p: v for p, v in t.items() if p.startswith(part)},
                       {p: v for p, v in j.items() if p.startswith(part)},
                       rtol, atol)
    for part in ("['params']", "['opt']['master']"):
        for p, w in j.items():
            if p.startswith(part):
                err = float(np.max(np.abs(t[p].astype(np.float64) - w)))
                bound = 2 * UPDATE_MAX * LR * k + 1e-6 * np.max(np.abs(w))
                assert err <= bound, (p, err, bound)
                dj = w.astype(np.float64) - s0[p]
                dt = t[p].astype(np.float64) - s0[p]
                nj = float(np.linalg.norm(dj))
                assert nj > 0.0, p
                assert float(np.linalg.norm(dt - dj)) <= STEP_RTOL * nj, p


def run_steps(arch, n_micro, B=4, S=24):
    jcfg, tcfg = cfgs(arch)
    jo, to = opt_cfgs()
    js = jts.init_train_state(jcfg, jax.random.PRNGKey(0))
    ts = state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    start = js
    jstep = jax.jit(jts.make_train_step(
        jcfg, JCtx(mesh=None, remat="none", q_chunk=64),
        jts.StepConfig(n_microbatches=n_micro, opt=jo)))
    tstep = tts.make_train_step(tcfg, TCtx(q_chunk=64),
                                tts.StepConfig(n_microbatches=n_micro, opt=to))
    for k in range(1, STEPS + 1):
        b = batch_np(jcfg, seed=10 + k, b=B, s=S)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        ts, tm = tstep(ts, to_torch(b))
        assert set(tm) == set(jm) == {"loss", "nll", "aux", "grad_norm",
                                      "lr"}
        for key, rtol in (("loss", LOSS_RTOL), ("nll", LOSS_RTOL),
                          ("grad_norm", GNORM_RTOL), ("lr", 1e-6)):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                rtol * abs(float(jm[key])), (key, k)
        if k in (1, STEPS):
            check_states(ts, js, k, start)
    return ts, js


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma3_4b",
                                  "hymba_1_5b"])
def test_train_step_matches_jax(arch, n_micro):
    ts, js = run_steps(arch, n_micro)
    if arch == "gemma3_4b":
        # tied at init, two leaves from the first update on, as in JAX
        t = ts["params"]
        assert not torch.equal(t["embed"], t["out_embed"])
        assert not np.array_equal(np.asarray(js["params"]["embed"]),
                                  np.asarray(js["params"]["out_embed"]))


def test_tied_embeddings_start_as_two_leaves():
    _, tcfg = cfgs("gemma3_4b")
    assert tcfg.tie_embeddings
    state = tts.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    p = state["params"]
    assert torch.equal(p["embed"], p["out_embed"])
    assert p["embed"].data_ptr() != p["out_embed"].data_ptr()
    # serving keeps the tie (one tensor), as init_params always did
    served = tzoo.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert served["embed"] is served["out_embed"]
    assert list(p) == sorted(p) and list(state["opt"]["m"]) == sorted(p)


def _tree(rng, n):
    """A nested tree like the LM's: dicts (keys out of order) and lists of
    stacked leaves, vectors that take no weight decay."""
    def a(*shape):
        return rng.randn(*shape).astype(np.float32) * 0.1
    return {"stages": [{"layers": {"w": a(2, 4, 3), "norm": a(2, 4)}},
                       {"layers": {"w": a(1, 4, 3), "norm": a(1, 4)}}],
            "embed": a(6, 4), "final_norm": a(4)}


def test_adamw_update_matches_jax_on_a_nested_tree():
    rng = np.random.RandomState(0)
    params = _tree(rng, 0)
    jo, to = opt_cfgs(lr=1e-2, warmup_steps=2, total_steps=5)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init_opt_state(jp)
    tp = state_from_reference(params, "cpu")
    tstate = topt.init_opt_state(tp)
    for _ in range(4):
        grads = _tree(rng, 1)
        jp, jstate, jm = jopt.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), jstate, jo)
        tp, tstate, tm = topt.adamw_update(
            tp, state_from_reference(grads, "cpu"), tstate, to)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        close_per_leaf(flat_torch({"p": tp, "o": tstate}),
                       flat_np({"p": jp, "o": jstate}), OPT_ULPS)
    assert list(tp) == sorted(params)   # the carried tree's order, kept


def _flat_adamw_before(params, grads, opt, cfg):
    """The GCN's AdamW as the port had it before trees: a flat dict walked
    in its own order (kept here as the yardstick)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads.values()))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt["step"] + 1
    lr = topt.lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), stepf)
    new_params, master, m, v = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m[k] = b1 * opt["m"][k] + (1 - b1) * g
        v[k] = b2 * opt["v"][k] + (1 - b2) * torch.square(g)
        update = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps)
        if p.dim() >= 2:
            update = update + cfg.weight_decay * opt["master"][k]
        master[k] = opt["master"][k] - lr * update
        new_params[k] = master[k].to(p.dtype)
    return new_params, {"master": master, "m": m, "v": v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def test_gcn_optimizer_results_unchanged():
    """The GCN's params (a flat dict, emb first) through three updates:
    the tree walk gives the flat walk's results bit for bit."""
    rng = np.random.RandomState(0)

    def gcn_like():
        return {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
                for k, s in (("emb", (4, 5, 8)), ("W1", (8, 16)),
                             ("b1", (16,)), ("W2", (16, 3)), ("b2", (3,)))}
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=1, clip_norm=0.5)
    params = gcn_like()
    a = b = (params, topt.init_opt_state(params))
    for _ in range(3):
        grads = gcn_like()
        pa, oa, ma = topt.adamw_update(*a[:1], grads, a[1], cfg)
        pb, ob, mb = _flat_adamw_before(*b[:1], grads, b[1], cfg)
        assert list(pa) == list(pb) == list(params)
        for k in params:
            for x, y in ((pa[k], pb[k]), (oa["master"][k], ob["master"][k]),
                         (oa["m"][k], ob["m"][k]), (oa["v"][k], ob["v"][k])):
                assert torch.equal(x, y), k
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])
        a, b = (pa, oa), (pb, ob)


def test_prefill_and_decode_step_factories():
    _, tcfg = cfgs("tinyllama_1_1b")
    params = tzoo.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ctx = TCtx(q_chunk=64)
    toks = torch.from_numpy(batch_np(tcfg, s=8)["tokens"])
    with torch.no_grad():
        logits, cache = tts.make_prefill_step(tcfg, ctx, max_len=12)(
            params, {"tokens": toks})
        want, want_cache = tzoo.prefill(params, tcfg, ctx, toks, max_len=12)
        assert torch.equal(logits, want)
        tok = tzoo.greedy(logits)
        got, _ = tts.make_decode_step(tcfg, ctx)(params, tok, cache)
        want, _ = tzoo.decode_step(params, tcfg, ctx, tok, want_cache)
    assert torch.equal(got, want)

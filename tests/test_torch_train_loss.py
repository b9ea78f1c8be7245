"""The port's LM training loss, continued (``test_torch_train.py`` has the
rules and tolerances): OLMoE's and Whisper's loss and gradients against
``jax.value_and_grad`` of the reference's ``loss_fn``; the three token
lookups (``gather``, ``onehot``, ``rr``) give the same loss bit for bit
(each reads the same table rows; a one-hot product adds exact zeros) and
gradients within float32 summation order (1e-6 of the leaf's max: the
one-hot product sums the rows in another order than ``index_add_``); the
recomputation modes ``none``, ``full`` and ``dots`` give the same loss and
gradients bit for bit (on the CPU a recomputed layer repeats the same
arithmetic), and a recomputed MoE layer records its routing once."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import model_zoo as tzoo  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import ModelContext as TCtx  # noqa: E402
from test_torch_train import (S, cfgs, check_loss_and_grads,  # noqa: E402
                              close_per_leaf, port_loss_and_grads,
                              state_from_reference)

EMBED_RTOL = 1e-6


@pytest.mark.parametrize("mode", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "whisper_medium"])
def test_loss_and_grads_match_jax(arch, mode):
    check_loss_and_grads(arch, mode)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma3_4b"])
def test_embed_methods_give_equal_losses(arch):
    out = {m: port_loss_and_grads(arch, TCtx(q_chunk=64, remat="none",
                                             embed_method=m))
           for m in ("gather", "onehot", "rr")}
    loss, _, grads = out["rr"]
    for m in ("gather", "onehot"):
        assert torch.equal(out[m][0], loss), m
        close_per_leaf(out[m][2], grads, EMBED_RTOL)
    with pytest.raises(ValueError, match="embed method"):
        TCtx(embed_method="dense")


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "hymba_1_5b",
                                  "olmoe_1b_7b", "whisper_medium"])
def test_remat_modes_give_equal_losses_and_grads(arch):
    _, tcfg = cfgs(arch)
    n_moe = tcfg.n_layers if tcfg.is_moe else 0
    out = {}
    for remat in ("none", "full", "dots"):
        tmoe.record = []
        try:
            out[remat] = port_loss_and_grads(
                arch, TCtx(q_chunk=max(S, 64), remat=remat, kernels="kernel"))
            # the backward recomputed every layer but "none": still one
            # record a MoE layer
            assert len(tmoe.record) == n_moe, (remat, len(tmoe.record))
        finally:
            tmoe.record = None
    loss, metrics, grads = out["none"]
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], loss), remat
        assert torch.equal(out[remat][1]["aux"], metrics["aux"])
        close_per_leaf(out[remat][2], grads, 0.0)
    with pytest.raises(ValueError, match="remat mode"):
        TCtx(remat="some")


def test_serving_is_not_recomputed():
    """Without a gradient (serving) no layer runs under the checkpoint:
    the default ``remat="full"`` changes nothing of a no-grad forward."""
    arch = "tinyllama_1_1b"
    _, tcfg = cfgs(arch)
    from test_torch_train import reference
    params = state_from_reference(reference(arch)[0], "cpu")
    tokens = torch.from_numpy(reference(arch)[1]["tokens"])
    seen = []
    saved = torch.utils.checkpoint.checkpoint

    def spy(*a, **k):
        seen.append(1)
        return saved(*a, **k)
    torch.utils.checkpoint.checkpoint = spy
    try:
        with torch.no_grad():
            a, _ = tzoo.forward_logits(params, tcfg, TCtx(q_chunk=64), tokens)
        b, _ = tzoo.forward_logits(params, tcfg,
                                   TCtx(q_chunk=64, remat="none"), tokens)
        c, _ = tzoo.forward_logits(params, tcfg, TCtx(q_chunk=64), tokens)
    finally:
        torch.utils.checkpoint.checkpoint = saved
    assert len(seen) == tcfg.n_layers      # the last forward's layers only
    assert torch.equal(a, b.detach()) and torch.equal(a, c.detach())

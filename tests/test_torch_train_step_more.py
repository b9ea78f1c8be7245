"""The port's train step against the JAX package, continued
(``test_torch_train_step.py`` has the rules and tolerances): OLMoE (the
aux loss in the loss and the gradient; the mirrored experts' unused
weights take zero gradients, as in JAX) and Whisper (the frame
embeddings in each batch), 1 and 3 steps at 1 and 2 microbatches."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import run_steps  # noqa: E402


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "whisper_medium"])
def test_train_step_matches_jax(arch, n_micro):
    ts, _ = run_steps(arch, n_micro)
    if arch == "olmoe_1b_7b":
        w = ts["params"]["stages"][0]["layers"]["moe"]
        for k in ("w_gate_m", "w_up_m", "w_down_m"):
            assert torch.count_nonzero(ts["opt"]["m"]["stages"][0]["layers"]
                                       ["moe"][k]) == 0, k
            assert torch.isfinite(w[k]).all()

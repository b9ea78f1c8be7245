"""Port: ``prefill`` and ``decode_step`` on the (data, model) mesh against
the JAX package's jitted mesh steps (the machinery, cases and tolerances
of ``test_torch_serve_mesh.py``) for reduced OLMoE (moe: each (data,
model) slice routes its own tokens with its own capacity, so the target
is the reference under its mesh, not its one-device steps; the attention
split over the model axis beside the token-split experts) and Whisper
(``enc`` / ``dec_cross``: the encoder and the cross-attention on each
rank's heads, ``enc_embeds`` split over the data axis with the prompts),
each on (1, 2), (2, 2) and (1, 4)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_serve_mesh import (MESHES, check_serve,  # noqa: E402
                                   results_for, serve_case)

CASES = [serve_case(a, m) for a in ("olmoe_1b_7b", "whisper_medium")
         for m in MESHES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return results_for(tmp_path_factory.mktemp("serve_mesh_moe"), CASES)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_serving_on_the_mesh_matches_jax(results, name):
    check_serve(*results[name])

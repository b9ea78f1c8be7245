"""Port: ``prefill`` and ``decode_step`` on the (data, model) mesh against
the JAX package's jitted mesh steps (the machinery, cases and tolerances
of ``test_torch_serve_mesh.py``) for reduced Hymba (hybrid: a window, a
global and a window stage; its attention and MLP split over the model
axis beside the SSM's d_inner columns and heads, the gated norm's RMS
summed over the model group) and Gemma-3 (tied embeddings: two
vocab-sharded leaves; window and global stages), each on (1, 2), (2, 2)
and (1, 4).  The window stages hold 16 slots: the third decode step wraps
their ring buffer (slot 0 rewritten) while the global stage's 24 slots
are split, so both meet the owner-written slot and the combine over
blocks without a valid key.  One more Hymba case on (1, 4) has SSM heads
of 64: d_inner 128 splits over 4 for ``cache_specs`` (the conv block's
columns) but 32 columns are not whole heads, so the SSM's leaves stay
whole and each decode step gathers the conv block and cuts it again
(Hymba-1.5B meets this at mp 16)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_serve_mesh import (ARCHS, MESHES,  # noqa: E402
                                   check_serve, results_for, serve_case)

CASES = [serve_case(a, m) for a in ("hymba_1_5b", "gemma3_4b")
         for m in MESHES] + [
    serve_case("hymba_1_5b", (1, 4), tag="-ssm64",
               over=dict(ARCHS["hymba_1_5b"], ssm={"head_dim": 64}))]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return results_for(tmp_path_factory.mktemp("serve_mesh_more"), CASES)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_serving_on_the_mesh_matches_jax(results, name):
    check_serve(*results[name])

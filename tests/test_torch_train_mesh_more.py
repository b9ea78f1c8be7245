"""Port: ``make_train_step`` on the training mesh against the JAX
package's mesh step (the machinery and tolerances of
``test_torch_train_mesh.py``): Gemma-3 reduced (tied embeddings: two
vocab-sharded leaves, each with its own gradient; window and global
layers) on (2, 2); TinyLlama reduced on (1, 1), (2, 1), (1, 2) and (1, 4)
(its 4 query heads split one a rank, its 2 kv heads whole: each read by
two ranks), each a gloo group of its own world size, and with 2
microbatches on (2, 2)
(microbatch i's rows of each data slice, as the reference's sharded batch
splits).  Gemma's state is saved on its mesh through ``save_gathered`` and
restored whole.  The (1, 1) mesh runs every collective on groups of one rank,
which the port skips: its step is the one-device step's arithmetic.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_mesh import check_case, run_both, train_case  # noqa: E402,E501

CASES = {
    4: [("gemma3_4b", (2, 2), 1), ("tinyllama_1_1b", (2, 2), 2),
        ("tinyllama_1_1b", (1, 4), 1)],
    2: [("tinyllama_1_1b", (2, 1), 1), ("tinyllama_1_1b", (1, 2), 1)],
    1: [("tinyllama_1_1b", (1, 1), 1)],
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_more")
    rounds = [(w, [train_case(*c) for c in cases])
                for w, cases in CASES.items()]
    rounds[0][1][0]["ckpt"] = str(tmp / "ckpt")   # gemma on (2, 2)
    want, got = run_both(tmp, rounds)
    out = {c["name"]: (c, want[c["name"]], got[c["name"]])
           for _, cases in rounds for c in cases}
    out["ckpt"] = tmp / "ckpt"
    return out


@pytest.mark.parametrize("case", [c for cs in CASES.values() for c in cs],
                         ids=lambda c: "%s-%dx%d-m%d" % (c[0], *c[1], c[2]))
def test_train_step_on_the_mesh_matches_jax(results, case):
    arch, (dp, mp), micro = case
    check_case(*results[f"{arch}-{dp}x{mp}-m{micro}"])


def test_save_gathered_writes_the_whole_state(results):
    """Rank 0 of the (2, 2) mesh saved the gathered state: a checkpoint of
    the whole leaves (vocab rows included), which restores without a mesh
    to rank 0's gathered state bit for bit."""
    from repro_torch.train import checkpoint as tckpt
    from test_torch_train_mesh import STEPS, _port_tree
    case, _, got = results["gemma3_4b-2x2-m1"]
    want = _port_tree("gemma3_4b", got["state"])
    restored, step = tckpt.restore(str(results["ckpt"]), want)
    assert step == STEPS
    flat = dict(tckpt._leaves_with_paths(restored))
    for path, leaf in tckpt._leaves_with_paths(want):
        assert torch.equal(flat[path], leaf), path
    assert flat["['params']['embed']"].shape[0] == 256

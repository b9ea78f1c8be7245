"""Port: ``make_train_step`` under the reference's remaining training-mesh
placements, against the JAX package's jitted mesh step under the same
``train_state_specs(zero1=, fsdp=)`` (the machinery and tolerances of
``test_torch_train_mesh.py``: the reference in a subprocess with 4 forced
host devices, the port on spawned gloo ranks that import no JAX, two
steps a case, rank 0 gathering the state).

* ZeRO-1 (``zero1``): each rank holds its block of the optimizer's
  master, m and v over the data axis; the gradients are reduce-scattered,
  AdamW runs on the blocks and the new parameters are all-gathered.
* fsdp: the parameters too; the model gathers a layer's blocks inside the
  recomputed layer and ``embed`` / ``out_embed`` / the final norms at
  their use, and the gather's backward sums each block's gradient.
* Stored expert shards: OLMoE's routed stacks hold E / mp experts a rank.

Cases: on (2, 2) TinyLlama under ZeRO-1 and under fsdp with 2
microbatches, Hymba under fsdp (SSM leaves split over both axes), OLMoE
under fsdp, Whisper under ZeRO-1 (the encoder stage and ``cross``); on
(4, 1) TinyLlama under fsdp (the data axis of size 4 falls off the layer
axis of 2 layers onto an inner dimension); on (2, 1) Gemma-3 under ZeRO-1
(tied embeddings, a 3-layer stage).  Every rank-0 leaf's shape is held to
``local_shape`` of its placed spec.  The (4, 1) fsdp state is saved
through ``save_gathered`` and restores whole bit for bit, and a second
(4, 1) fsdp run, cut after step 1, saved, restored and placed again
through ``resharded``, ends bit for bit where the straight run ends.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_mesh import (STEPS, _port_tree, check_case,  # noqa: E402,E501
                                   run_both, train_case)

CASES = {
    4: [("tinyllama_1_1b", (2, 2), 1, "zero1"),
        ("tinyllama_1_1b", (2, 2), 2, "fsdp"),
        ("hymba_1_5b", (2, 2), 1, "fsdp"),
        ("olmoe_1b_7b", (2, 2), 1, "fsdp"),
        ("whisper_medium", (2, 2), 1, "zero1"),
        ("tinyllama_1_1b", (4, 1), 1, "fsdp")],
    2: [("gemma3_4b", (2, 1), 1, "zero1")],
}
CKPT_CASE = "tinyllama_1_1b-4x1-m1-fsdp"


def _name(c):
    return "%s-%dx%d-m%d-%s" % (c[0], *c[1], c[2], c[3])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_zero")
    rounds = [(w, [train_case(*c) for c in cases])
              for w, cases in CASES.items()]
    cases = rounds[0][1]
    straight = next(c for c in cases if c["name"] == CKPT_CASE)
    straight["ckpt"] = str(tmp / "ckpt")
    # the same run cut after step 1 and resumed (the port alone)
    cases.append(dict(straight, name=CKPT_CASE + "-resumed", ckpt=None,
                      cut=1, cut_dir=str(tmp / "cut"), port_only=True))
    want, got = run_both(tmp, rounds)
    out = {c["name"]: (c, want.get(c["name"]), got[c["name"]])
           for _, cs in rounds for c in cs}
    out["ckpt"] = tmp / "ckpt"
    return out


@pytest.mark.parametrize("case", [c for cs in CASES.values() for c in cs],
                         ids=_name)
def test_train_step_under_zero1_and_fsdp_matches_jax(results, case):
    check_case(*results[_name(case)])


def test_save_gathered_from_fsdp_restores_whole(results):
    """Rank 0 of the (4, 1) fsdp run saved the gathered state: whole
    leaves, which restore without a mesh to rank 0's gathered state bit
    for bit."""
    from repro_torch.train import checkpoint as tckpt
    case, _, got = results[CKPT_CASE]
    want = _port_tree(case["arch"], got["state"])
    restored, step = tckpt.restore(str(results["ckpt"]), want)
    assert step == STEPS
    flat = dict(tckpt._leaves_with_paths(restored))
    for path, leaf in tckpt._leaves_with_paths(want):
        assert torch.equal(flat[path], leaf), path
    # the blocks were split: a layer's wq was a quarter of its d_model rows
    assert got["local_shapes"][
        "['params']['stages'][0]['layers']['attn']['wq']"][1] * 4 == \
        flat["['params']['stages'][0]['layers']['attn']['wq']"].shape[1]


def test_fsdp_run_resumed_through_resharded_is_bitwise(results):
    """The run cut after step 1, restored whole and placed again on the
    fsdp placement, takes step 2 to the straight run's state and metrics
    bit for bit."""
    _, _, straight = results[CKPT_CASE]
    _, _, resumed = results[CKPT_CASE + "-resumed"]
    assert resumed["metrics"] == straight["metrics"]
    assert set(resumed["state"]) == set(straight["state"])
    for path, leaf in straight["state"].items():
        assert (resumed["state"][path].tobytes() == leaf.tobytes()), path

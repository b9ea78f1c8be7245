"""Port: bfloat16 checkpoint leaves in the JAX package's format.  numpy
has no bfloat16: the reference's ``save`` writes such a leaf with the
manifest dtype ``"bfloat16"`` and an ``.npy`` of 2-byte voids holding the
bits.  The port writes the same (a ``|V2`` array and the same manifest)
and restores it bit for bit, also from a checkpoint the reference wrote;
float32 leaves beside them are unchanged.  Then ``save_gathered`` on a
(1, 1) mesh (an in-process gloo group of one rank) and ``resharded`` in
its mesh form.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402


def _tree():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5).astype(np.float32) * 100
    x[0, :3] = [np.inf, -0.0, 1e-40]            # inf, -0, a subnormal
    return x, rng.randn(4).astype(np.float32)


def _bits(t):
    return t.view(torch.int16).numpy()


def test_bfloat16_round_trip_is_bitwise(tmp_path):
    x, y = _tree()
    tree = {"w": torch.from_numpy(x).to(torch.bfloat16),
            "v": [torch.from_numpy(y)]}
    tckpt.save(str(tmp_path), 3, tree)
    meta = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert [m["dtype"] for m in meta["leaves"]] == ["float32", "bfloat16"]
    arr = np.load(tmp_path / "step_3" / "arr_1.npy")
    assert arr.dtype == np.dtype("V2") and arr.shape == (3, 5)
    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
            "v": [torch.zeros(4)]}
    got, step = tckpt.restore(str(tmp_path), like)
    assert step == 3 and got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["w"]), _bits(tree["w"]))
    assert torch.equal(got["v"][0], tree["v"][0])


def test_restores_a_bfloat16_checkpoint_the_reference_wrote(tmp_path):
    x, y = _tree()
    jtree = {"w": jnp.asarray(x).astype(jnp.bfloat16), "v": [jnp.asarray(y)]}
    jckpt.save(str(tmp_path / "ref"), 1, jtree)
    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
            "v": [torch.zeros(4)]}
    got, _ = tckpt.restore(str(tmp_path / "ref"), like)
    want = np.asarray(jtree["w"]).view(np.int16)
    np.testing.assert_array_equal(_bits(got["w"]), want)
    np.testing.assert_array_equal(got["v"][0].numpy(), y)
    # the port writes what the reference wrote: the same manifest, the
    # same bits in the .npy
    tckpt.save(str(tmp_path / "port"), 1, got)
    for name in ("manifest.json", "arr_0.npy", "arr_1.npy"):
        a, b = (tmp_path / d / "step_1" / name for d in ("ref", "port"))
        if name.endswith(".json"):
            assert a.read_text() == b.read_text()
        else:
            assert np.load(a).tobytes() == np.load(b).tobytes()
            assert np.load(a).dtype.itemsize == np.load(b).dtype.itemsize


def test_save_gathered_and_resharded_on_a_one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import shardings as sh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = meshlib.make_mesh((1, 1), ("data", "model"))
        assert (mesh.data_size, mesh.model_size) == (1, 1)
        x, y = _tree()
        tree = {"embed": torch.from_numpy(x), "norm": torch.from_numpy(y)}
        specs = {"embed": ("model", None), "norm": (None,)}
        local = tckpt.resharded(tree, mesh, specs)
        assert torch.equal(local["embed"], tree["embed"])
        path = tckpt.save_gathered(str(tmp_path), 2, local, specs, mesh)
        got, step = tckpt.restore(str(tmp_path), tree)
        assert path.endswith("step_2") and step == 2
        assert all(torch.equal(got[k], tree[k]) for k in tree)
    finally:
        meshlib.destroy()

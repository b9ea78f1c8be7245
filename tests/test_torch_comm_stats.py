"""Port: the collective recorder (``launch.comm_stats``, the counterpart of
``repro.launch.hlo_stats``).

The reference's ``test_collective_parser`` numbers, recorded from the
collectives themselves (an f32[16,8] all-reduce: 512 bytes, count 1; its
all-gather: 512 bytes, the operand, not the output) equal what the
reference parses from the same program's HLO text; then each function of
``models/collectives.py``, forward and backward, is recorded as the
collective it calls, on ``meta`` tensors in a fake world of 4 ranks.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.launch.hlo_stats import collective_bytes as hlo_bytes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.comm_stats import record_collectives  # noqa: E402
from repro_torch.models import collectives as coll  # noqa: E402

HLO = """
  %p = f32[16,8]{1,0} parameter(0)
  %ar = f32[16,8]{1,0} all-reduce(%p), replica_groups={}
  %ag = f32[64,8]{1,0} all-gather(%p), dimensions={0}
  %done = f32[16,8]{1,0} all-reduce-done(%ar)
"""


@contextlib.contextmanager
def world(n=4):
    with dryrun.fake_world(n):
        yield dist.group.WORLD


def test_the_reference_parser_numbers():
    x = torch.empty(16, 8, device="meta")
    with world() as g, record_collectives() as rec:
        dist.all_reduce(x, group=g)
        coll.all_gather(x, g)
    out = rec.stats()
    assert out["all-reduce"] == {"bytes": 16 * 8 * 4, "count": 1}
    assert out["all-gather"] == {"bytes": 16 * 8 * 4, "count": 1}
    want = hlo_bytes(HLO)
    assert out == want
    assert [op.shapes for op in rec.ops] == [((16, 8),), ((16, 8),)]
    assert [op.group_size for op in rec.ops] == [4, 4]


def _grad_of(fn, x):
    x = x.detach().requires_grad_(True)
    y = fn(x)
    y.backward(torch.empty_like(y))


# function, its forward's kinds, its backward's kinds
FUNCTIONS = {
    "psum_replicated": (lambda x, g: coll.psum_replicated(x, g),
                        ["all-reduce"], []),
    "sum_cotangents": (lambda x, g: coll.sum_cotangents(x, g),
                       [], ["all-reduce"]),
    "all_to_all": (lambda x, g: coll.all_to_all(x, g), ["all-to-all"],
                   ["all-to-all"]),
    "gather_slices": (lambda x, g: coll.gather_slices(x, g, 0),
                      ["all-gather"], []),
    "split_slices": (lambda x, g: coll.split_slices(x, g), [],
                     ["all-gather"]),
    "gather_data_dim": (lambda x, g: coll.gather_data(x, g, 1),
                        ["all-gather"], ["reduce-scatter"]),
    "gather_data_owner": (lambda x, g: coll.gather_data(x, g, None, 0),
                          ["all-reduce"], ["all-reduce"]),
    "DataBlock_whole": (lambda x, g: coll.DataBlock(x, g, 0).whole(),
                        ["all-gather"], ["reduce-scatter"]),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_collectives_module_forward_and_backward(name):
    fn, fwd, bwd = FUNCTIONS[name]
    x = torch.empty(8, 4, device="meta", requires_grad=True)
    with world() as g:
        with record_collectives() as rec_f:
            y = fn(x, g)
        with record_collectives() as rec_b:
            y.backward(torch.empty_like(y))
    assert [op.kind for op in rec_f.ops] == fwd
    assert [op.kind for op in rec_b.ops] == bwd
    assert all(op.group_size == 4 for op in rec_f.ops + rec_b.ops)
    assert x.grad is not None and x.grad.shape == x.shape


@pytest.mark.parametrize("name", ["reduce_scatter", "all_gather"])
def test_zero1_exchanges(name):
    x = torch.empty(8, 4, device="meta")
    with world() as g, record_collectives() as rec:
        y = getattr(coll, name)(x, g, 0)
    kind = name.replace("_", "-")
    assert [op.kind for op in rec.ops] == [kind]
    assert rec.ops[0].bytes == 8 * 4 * 4      # the operand, either way
    assert y.shape[0] == (2 if name == "reduce_scatter" else 32)


def test_one_rank_groups_call_no_collective():
    x = torch.empty(8, 4, device="meta", requires_grad=True)
    with world(1) as g, record_collectives() as rec:
        for fn, _, _ in FUNCTIONS.values():
            y = fn(x, g)
            y.backward(torch.empty_like(y))
    assert rec.ops == [] and rec.stats()["total"] == {"bytes": 0,
                                                      "count": 0}

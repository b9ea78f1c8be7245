"""Port parity: the sharded executor's host tables against the reference.

``repro_torch.core.exec`` keeps its own copies of the reference's numpy
table builders (caps, device bounds, per-device plans and their stacking,
fetch plans, the whole ``_shard_graph``).  On the same partition they must
give the reference's arrays bitwise, at D in {1, 2, 4}, in both layouts;
and the tables must be exact: every real segment and every needed slot is
routed once, every padded slot is masked.  No process group is needed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import exec as ref_exec  # noqa: E402
from repro_torch.core import exec as texec  # noqa: E402
from test_torch_graph import graph_pair, same_partition  # noqa: E402

NB = 32                       # the reference's block width off the TPU
DS = [1, 2, 4]
LAYOUTS = ["padded", "csr"]


def _pair(layout, tau=8, seed=1, n=300):
    g_ref, _ = graph_pair("powerlaw", n, seed=5, weighted=True)
    return same_partition(g_ref, 8, tau=tau, seed=seed, layout=layout)


@pytest.mark.parametrize("L,D,hint", [(0, 1, None), (1, 2, None),
                                      (100, 4, None), (100, 4, 3),
                                      (100, 4, 60), (100, 4, 500),
                                      (7, 8, 2), (4096, 2, 4096)])
def test_cap_for_equal(L, D, hint):
    assert texec._cap_for(L, D, hint) == ref_exec._cap_for(L, D, hint)


@pytest.mark.parametrize("D", DS)
def test_device_bounds_equal(D):
    pg_ref, pg_t = _pair("csr")
    want = ref_exec.device_edge_bounds(pg_ref, D)
    got = texec.device_edge_bounds(pg_t, D)
    assert got["phys"] is None and want["phys"] is None
    for k in ("eg", "all", "mir"):
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            texec.csr_device_bounds(getattr(pg_t, {"eg": "eg_off",
                                                   "all": "all_off",
                                                   "mir": "mir_eoff"}[k]),
                                    pg_t.M, D), want[k])
    assert texec._cap_hint(pg_t, D) == ref_exec._cap_hint(pg_ref, D)


def _plan_fields(p):
    return {k: getattr(p, k) for k in (
        "M_src", "M_dst", "n_loc", "nb", "eb", "B_per_w", "n_blocks",
        "n_segs", "n_rows", "row_gather", "row_valid", "row_local",
        "row_seg", "seg_blk", "seg_worker")}


@pytest.mark.parametrize("kind", ["eg", "all", "mir"])
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_device_plans_and_stacking_equal(layout, D, kind):
    pg_ref, pg_t = _pair(layout)
    want = ref_exec._device_plans(pg_ref, D, kind, NB)
    got = texec._device_plans(pg_t, D, kind, NB)
    assert len(got) == len(want) == D
    for a, b in zip(got, want):
        fa, fb = _plan_fields(a), _plan_fields(b)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]),
                                          np.asarray(fb[k]), err_msg=k)
    m = pg_t.M // D
    meta_w, arr_w = ref_exec._stack_plans(want, m)
    meta_g, arr_g = texec._stack_plans(got, m)
    assert meta_g == meta_w
    assert set(arr_g) == set(arr_w)
    for k in arr_w:
        assert arr_g[k].dtype == arr_w[k].dtype, k
        np.testing.assert_array_equal(arr_g[k], arr_w[k], err_msg=k)


@pytest.mark.parametrize("kind", ["eg", "all", "mir"])
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stacked_plans_route_every_segment_once(layout, D, kind):
    """Exact caps: each real segment of device d sits in exactly one send
    slot, bound for the device owning its block, and arrives as that
    block; padded send and receive slots are masked."""
    _, pg_t = _pair(layout)
    plans = texec._device_plans(pg_t, D, kind, NB)
    m = pg_t.M // D
    meta, a = texec._stack_plans(plans, m)
    bpd = m * plans[0].B_per_w
    for d, p in enumerate(plans):
        sent = []
        for d2 in range(D):
            segs = a["xseg"][d, d2][a["xval"][d, d2]]
            assert (p.seg_blk[segs] // bpd == d2).all()
            np.testing.assert_array_equal(
                a["rblk"][d2, d][a["rval"][d2, d]],
                p.seg_blk[segs] - d2 * bpd)
            sent.append(segs)
            # the valid lanes are a prefix; the rest is padding
            c = int(a["xval"][d, d2].sum())
            assert not a["xval"][d, d2, c:].any()
        np.testing.assert_array_equal(np.sort(np.concatenate(sent)),
                                      np.arange(p.n_segs))
        assert not a["row_valid"][d, p.n_rows:].any()
        assert (a["row_local"][d, p.n_rows:] == -1).all()
    assert meta["xcap"] == max(1, max(
        int(a["xval"][d, d2].sum()) for d in range(D) for d2 in range(D)))


@pytest.mark.parametrize("D", DS)
def test_fetch_plan_equal_and_exact(D):
    rng = np.random.RandomState(D)
    loc_n = 37
    need = [np.unique(rng.randint(0, D * loc_n, rng.randint(0, 40)))
            for _ in range(D)]
    if D > 1:
        need[1] = np.zeros(0, np.int64)            # a device needing nothing
    meta_w, arr_w = ref_exec._build_fetch_plan(need, D, loc_n)
    meta_g, arr_g = texec._build_fetch_plan(need, D, loc_n)
    assert meta_g == meta_w
    for k in arr_w:
        np.testing.assert_array_equal(arr_g[k], arr_w[k], err_msg=k)
    send, recv = arr_g["send_slot"], arr_g["recv_pos"]
    for d in range(D):
        got = np.full(len(need[d]), -1)
        for s in range(D):
            ok = recv[d, s] >= 0
            assert ((send[s, d] >= 0) == ok).all()
            got[recv[d, s][ok]] = send[s, d][ok] + s * loc_n
        np.testing.assert_array_equal(got, need[d])


@pytest.mark.parametrize("plan_kinds", [(), ("eg", "mir"), ("all",)])
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_shard_graph_equal(layout, D, plan_kinds):
    pg_ref, pg_t = _pair(layout)
    meta_w, arr_w, _ = ref_exec._shard_graph(pg_ref, D, plan_kinds)
    meta_g, arr_g = texec._shard_graph(pg_t, D, plan_kinds, NB)
    for k in ("M", "n_loc", "D", "m_loc", "n", "tau", "layout", "cap_hint",
              "plan_meta", "fetch_meta"):
        assert meta_g[k] == meta_w[k], k
    assert set(arr_g) == set(arr_w)
    for k in arr_w:
        np.testing.assert_array_equal(np.asarray(arr_g[k]),
                                      np.asarray(arr_w[k]), err_msg=k)


@pytest.mark.parametrize("D", DS)
def test_device_slices_pad_with_masked_real_slots(D):
    """csr edge slices: the padding of each device's slice is masked off,
    and a padded source is one of the device's own slots, so an unmasked
    read of it stays in bounds."""
    _, pg_t = _pair("csr")
    meta, a = texec._shard_graph(pg_t, D, (), NB)
    m_n = meta["m_loc"] * meta["n_loc"]
    for name, off in (("eg", pg_t.eg_off), ("all", pg_t.all_off)):
        counts = np.diff(texec.csr_device_bounds(off, pg_t.M, D))
        for d in range(D):
            mask = a[f"{name}_mask"][d]
            assert mask.sum() == counts[d] and mask[:counts[d]].all()
            src = a[f"{name}_src"][d]
            assert ((src >= d * m_n) & (src < (d + 1) * m_n)).all()
    # every mirror edge's fetched position is inside the compact buffer
    n_need = meta["fetch_meta"]["mir"]["n_need"]
    assert ((a["mir_cesrc"] >= 0) & (a["mir_cesrc"] < n_need)).all()

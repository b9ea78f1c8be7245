"""Sharded-vs-single-device parity and collective harness over
``torch.distributed`` (the counterpart of ``repro.launch.shard_check``).

Runs algorithm x layout x backend cells of the conformance matrix through
the sharded executor (``core/exec.py``) at each requested device count
and compares against the sequential single-device run of the same
partition:

* integer / min / max results (hashmin, sssp, sv, msf labels, attribute
  broadcast) must be **bitwise identical**;
* PageRank and MSF's total weight (float sums) within ``allclose(rtol=1e-5,
  atol=1e-7)``: the exchange changes the float reduction order only;
* every ``msgs_*`` / ``per_worker_*`` statistic must be integer-exact, in
  the same number of supersteps;
* the dense sharded Ch_msg must issue an ``all_to_all_single`` over the
  whole mesh (``check_all_to_all``);
* the routed-exchange memory contract: no ``all_reduce`` or
  ``all_gather`` operand of the gated channel programs may reach
  ``n_pad`` elements (``check_routed_memory``; the destination-routed
  exchange exists to remove the per-device O(n) replicated buffers);
* masked request lanes never leak into gathered values
  (``check_masked_lanes``);
* on the ``(hosts, per_host)`` mesh every gated program issues
  all-to-alls in groups of size T (intra-host) AND of size H
  (cross-host), with no replicated buffer at either level
  (``check_hier_levels``; for feature-blocked gSpMM joins at F=1 and F=4
  ``check_gspmm_hier``), and per-level caps far below the traffic still
  give bitwise results through overflow rounds (``check_hier_caps``).

The reference reads its collectives from compiled HLO.  Here the gates
read them from ``record_collectives()``, which wraps
``torch.distributed.all_to_all_single``, ``all_reduce``, ``all_gather``
and ``broadcast`` (the functions the executor reaches through its
``dist`` module) and logs each call's op, group size and operand element
counts (an all-gather's operands are its input and its gathered output),
but only while a superstep's step function (``make_step(g)``'s result)
or an ``apply_sharded`` program (``make_fn(g)``'s result) runs.  What
runs after the loop is outside: the final ``_gather_state`` all-gather
and the stats all-reduce of ``run_sharded`` / ``apply_sharded``, which
the reference's compiled programs lack too (their outputs stay sharded).
A gate that records no collective at all fails.  The suites also run
each gate on a program built to violate it (``run_controls``: an
all-gather of the state, a 1-D mesh for the two-level gate, a step with
no collective), and each gate must reject its control.

Process model: the collectives run on the default group, so D is the
world size.  The cells are grouped by world size (8 serves ``8`` and
``2x4``, whose subgroups come from ``launch.mesh.graph_mesh``); each
world is one spawn of ranks (``graph_run.spawn_ranks``) meeting through
a file store; every rank runs every cell of its world, rank 0 also runs
the single-device side, prints and writes its report.  ``--device
cuda`` (the default) gives NCCL with a card a rank where there are
enough cards, else gloo with every rank on cuda:0, and raises when no
card is visible; only ``--device cpu`` gives gloo on the CPU.  On the
card each gated program's report also holds its peak device bytes
(``max_memory_allocated`` after ``reset_peak_memory_stats``, tables
built beforehand); on the CPU they are omitted.

    PYTHONPATH=src python -m repro_torch.launch.shard_check --suite tier1 \\
        --device cpu --out shard-parity.json

``--suite tier1`` is the consolidated fast profile, ``hier`` every
algorithm on every factorization of 8 devices, ``full`` the nightly
matrix; explicit ``--devices/--algos/--balance/--layouts`` (+
``--pipeline``) compose a custom matrix instead.  Prints ``[shard_check]
ALL CELLS OK`` and exits 0, or exits 1 after the first world whose cells
or gates failed.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import datetime
import json
import sys
import tempfile
from pathlib import Path

ALGOS = ("hashmin", "pagerank", "sssp", "sv", "msf", "attr_bcast")
GROUP_TIMEOUT_S = 300
SPAWN_TIMEOUT_S = 3600
RECORDED = ("all_to_all_single", "all_reduce", "all_gather", "broadcast")


def _dev_tag(devices) -> str:
    """Cell-label spelling of a device count: ``8`` or ``2x4``."""
    if isinstance(devices, tuple):
        return "x".join(str(d) for d in devices)
    return str(devices)


def _flat_devices(devices) -> int:
    """Ranks a mesh spec needs: H*T for tuples."""
    if isinstance(devices, tuple):
        out = 1
        for d in devices:
            out *= int(d)
        return out
    return int(devices)


def _host(x):
    """Tensors (and tuples of them) as numpy."""
    if isinstance(x, (tuple, list)):
        return tuple(_host(v) for v in x)
    return x.detach().cpu().numpy()


def _log(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def run_matrix(algos=ALGOS, layouts=("padded", "csr"),
               backends=("dense", "pallas"), device_counts=(1, 2, 8),
               n=180, M=8, tau=8, seed=0, balance="hash",
               split_factor=1.1, pipeline=False, device="cpu"):
    """Returns (report dict, ok flag) on rank 0 (the other ranks run the
    sharded side and return an empty report).  Every rank of the default
    group calls it with the same arguments; ``device_counts`` must all
    need the group's world size.  ``balance="split"`` needs the csr
    layout, so padded cells are skipped there.  ``pipeline=True`` runs the
    SHARDED side through the double-buffered executor while the
    single-device side stays sequential."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import Engine, config_of
    from repro_torch.core.exec import crossness_report
    from repro_torch.graph import generators as gen
    from repro_torch.graph.structs import partition

    rank = dist.get_rank()
    if balance == "split":
        layouts = tuple(lay for lay in layouts if lay == "csr")
    g = gen.powerlaw(n, avg_deg=5, seed=1, weighted=True).symmetrized()
    pgs = {lay: partition(g, M, tau=tau, seed=seed, layout=lay,
                          balance=balance, split_factor=split_factor,
                          device=device)
           for lay in layouts}

    def run_algo(algo, pg, backend, devices, pipe=False):
        # one Engine per cell: the config IS the cell coordinates
        eng = Engine(config_of(pg, backend=backend, devices=devices,
                               pipeline=pipe), device=device)
        if algo == "attr_bcast":
            attr = torch.arange(pg.n_pad, dtype=torch.float32,
                                device=device).reshape(pg.M, pg.n_loc) * 3
            res = eng.run("attr_bcast", pg, attr=attr)
            return {"exact": _host(res.state)}, {}, res.stats, 2
        params = {"pagerank": dict(n_iters=8, tol=1e-12),
                  "sssp": dict(source=int(pg.perm[0]))}.get(algo, {})
        res = eng.run(algo, pg, **params)
        if algo == "pagerank":
            return ({}, {"pr": _host(res.state)}, res.stats,
                    int(res.n_supersteps))
        if algo == "msf":
            lab, tw, ne = res.state
            return ({"exact": _host(lab), "ne": int(ne)},
                    {"tw": float(tw)}, res.stats, int(res.n_supersteps))
        return ({"exact": _host(res.state)}, {}, res.stats,
                int(res.n_supersteps))

    report = {"n": n, "M": M, "tau": tau, "balance": balance,
              "pipeline": bool(pipeline), "cells": {}, "crossness": {},
              "reference": {}}
    # the locality number the balance mode optimizes
    Dmax = max(_flat_devices(d) for d in device_counts)
    for lay, pg in pgs.items():
        cr = crossness_report(pg, Dmax if M % Dmax == 0 else None)
        report["crossness"][f"{lay}/{balance}"] = cr
        line = (f"[shard_check] crossness {lay}/{balance}: "
                f"cross-worker={cr['cross_worker_frac']:.3f}")
        if "cross_device_frac" in cr:
            line += (f" cross-device={cr['cross_device_frac']:.3f}"
                     f" (D={cr['D']})")
        _log(rank, line)
    ok = True
    pipe_tag = "/pipeline" if pipeline else ""
    for algo in algos:
        for lay in layouts:
            for be in backends:
                pg = pgs[lay]
                # the reference is ALWAYS the sequential single-device run
                if rank == 0:
                    ref_e, ref_a, ref_s, ref_n = run_algo(algo, pg, be, None)
                    report["reference"][f"{algo}/{lay}/{be}/{balance}"] = {
                        "supersteps": ref_n,
                        "msgs": {k: int(v) for k, v in ref_s.items()
                                 if k.startswith("msgs_")}}
                for D in device_counts:
                    e, a, s, nss = run_algo(algo, pg, be, D, pipe=pipeline)
                    if rank:
                        continue
                    name = (f"{algo}/{lay}/{be}/{balance}/"
                            f"devices={_dev_tag(D)}{pipe_tag}")
                    errs = []
                    if nss != ref_n:
                        errs.append(f"supersteps {nss} != {ref_n}")
                    for k in ref_e:
                        if not np.array_equal(np.asarray(e[k]),
                                              np.asarray(ref_e[k])):
                            errs.append(f"result {k!r} not bitwise equal")
                    for k in ref_a:
                        if not np.allclose(a[k], ref_a[k],
                                           rtol=1e-5, atol=1e-7):
                            errs.append(f"result {k!r} out of tolerance")
                    if set(s) != set(ref_s):
                        errs.append("stats keys differ")
                    else:
                        for k in ref_s:
                            if not np.array_equal(np.asarray(s[k]),
                                                  np.asarray(ref_s[k])):
                                errs.append(f"stat {k!r} differs: "
                                            f"{np.asarray(s[k])} vs "
                                            f"{np.asarray(ref_s[k])}")
                    report["cells"][name] = errs
                    ok &= not errs
                    _log(rank, f"[shard_check] {name}: "
                         + ("OK" if not errs else "; ".join(errs)))
    return report, ok


def _test_graph(n, M, tau, layout="csr", balance="hash", device="cpu"):
    from repro_torch.graph import generators as gen
    from repro_torch.graph.structs import partition

    g = gen.powerlaw(n, avg_deg=5, seed=1, weighted=True).symmetrized()
    return partition(g, M, tau=tau, seed=0, layout=layout, balance=balance,
                     split_factor=1.1, device=device)


# ---------------------------------------------------------------------------
# the collective recorder
# ---------------------------------------------------------------------------

class CollectiveLog:
    """The collectives issued while a wrapped program ran: ``calls`` holds
    ``(op, group_size, operand element counts)`` a call."""

    def __init__(self):
        self.calls = []
        self.active = False

    def during(self, fn):
        """``fn`` with the recording on while it runs."""
        def run(*args, **kw):
            self.active = True
            try:
                return fn(*args, **kw)
            finally:
                self.active = False
        return run


def _entry(op, args, kw):
    """(op, group size, operand element counts) of one call; the executor
    passes a subgroup by keyword (``group=``), the default group by none."""
    import torch.distributed as dist
    if op == "all_to_all_single":          # (output, input, ...)
        elems = [args[1].numel(), args[0].numel()]
    elif op == "all_gather":               # (output list, input)
        elems = [args[1].numel(), sum(t.numel() for t in args[0])]
    else:                                  # all_reduce, broadcast (tensor)
        elems = [args[0].numel()]
    return op, dist.get_world_size(kw.get("group")), elems


@contextlib.contextmanager
def record_collectives():
    """Wrap the four collectives the executor issues; yields a
    ``CollectiveLog`` whose ``during(fn)`` records what ``fn`` issues."""
    import torch.distributed as dist
    log = CollectiveLog()
    originals = {name: getattr(dist, name) for name in RECORDED}

    def wrap(name, fn):
        def recorded(*args, **kw):
            if log.active:
                log.calls.append(_entry(name, args, kw))
            return fn(*args, **kw)
        return recorded
    for name, fn in originals.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield log
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def collective_summary(calls) -> dict:
    """Per op the calls and the largest operand (elements), and the group
    sizes of the all-to-alls."""
    worst = {op: 0 for op in RECORDED}
    count = collections.Counter()
    sizes = set()
    for op, size, elems in calls:
        count[op] += 1
        worst[op] = max([worst[op]] + list(elems))
        if op == "all_to_all_single":
            sizes.add(size)
    return {"calls": len(calls), "ops": dict(count),
            "collective_max_elems": worst,
            "all_to_all_group_sizes": sorted(sizes)}


def replicated_elems(entry: dict) -> int:
    """The largest all-reduce / all-gather operand of a program."""
    worst = entry["collective_max_elems"]
    return max(worst["all_reduce"], worst["all_gather"])


def routed_ok(entry: dict, n_pad: int) -> bool:
    """No replicated buffer: some collective ran, and no all-reduce or
    all-gather operand reached n_pad elements."""
    return entry["calls"] > 0 and replicated_elems(entry) < n_pad


def two_levels_ok(entry: dict, H: int, T: int) -> bool:
    """All-to-alls in groups of size T and of size H."""
    return {H, T} <= set(entry["all_to_all_group_sizes"])


def has_all_to_all(entry: dict, D: int) -> bool:
    """An all-to-all over the whole mesh of D ranks."""
    return D in entry["all_to_all_group_sizes"]


def _program_entry(log, run, device) -> dict:
    """Record what ``run()`` issues (it wraps its steps in
    ``log.during``); with the peak device bytes of the run on the card."""
    import torch
    log.calls = []
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run()
    entry = collective_summary(log.calls)
    if cuda:
        torch.cuda.synchronize(device)
        entry["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return entry


def _run_steps(log, pg, make_step, devices, kinds, device, supersteps=3):
    """A BSP program of ``make_step`` from the min-label state, its
    tables built first (outside the peak and the record)."""
    import torch
    from repro_torch.core import exec as exec_mod
    from repro_torch.core.plan import identity_of

    imax = identity_of("min", torch.int32)

    def init(g):
        return torch.where(g.vmask, g.local_ids().to(torch.int32), imax)
    exec_mod.shard(pg, devices, kinds, device)

    def run():
        exec_mod.run_sharded(pg, lambda g: log.during(make_step(g)), init,
                             supersteps, devices=devices, plan_kinds=kinds,
                             device=device)
    return run


def _bcast_step(backend):
    import torch
    from repro_torch.core.channels import broadcast

    def make_step(g):
        def step(state, i):
            inbox, stats = broadcast(g, state, g.vmask, op="min",
                                     backend=backend)
            return torch.minimum(state, inbox), g.gany(inbox < state), stats
        return step
    return make_step


def _scatter_step(g):
    from repro_torch.core.channels import scatter_state

    # S-V-style runtime-target scatter: targets are algorithm state
    def step(state, i):
        new, stats = scatter_state(g, state, state, state, g.vmask, "min")
        return new, g.gall(new == state), stats
    return step


def _gather_step(g):
    import torch
    from repro_torch.core.channels import gather

    # request-respond pointer chase (the Ch_req two-round trip)
    def step(state, i):
        got, stats = gather(g, state, state, g.vmask)
        new = torch.minimum(state, got)
        return new, g.gall(new == state), stats
    return step


def channel_programs(pg, devices, device="cpu") -> dict:
    """Run one representative sharded program a gated join family under
    the recorder: ``{name: entry}`` (``collective_summary`` plus, on the
    card, ``peak_bytes``)."""
    from repro_torch.core import exec as exec_mod

    progs = {}
    with record_collectives() as log:
        for name, mk, kinds in (
                ("broadcast_dense", _bcast_step("dense"), ()),
                ("broadcast_plan", _bcast_step("pallas"),
                 exec_mod.broadcast_plan_kinds("pallas")),
                ("runtime_scatter", _scatter_step, ()),
                ("request_respond", _gather_step, ())):
            progs[name] = _program_entry(
                log, _run_steps(log, pg, mk, devices, kinds, device), device)
    return progs


def _peak_text(entry) -> str:
    if "peak_bytes" not in entry:
        return ""
    return f", peak {entry['peak_bytes']:,d} device bytes"


def check_all_to_all(n=180, M=8, tau=8, devices=8, device="cpu") -> bool:
    """The sharded dense Ch_msg join must issue a real all-to-all over the
    whole mesh."""
    import torch.distributed as dist
    pg = _test_graph(n, M, tau, device=device)
    with record_collectives() as log:
        entry = _program_entry(log, _run_steps(
            log, pg, _bcast_step("dense"), devices, (), device), device)
    found = has_all_to_all(entry, _flat_devices(devices))
    _log(dist.get_rank(), f"[shard_check] dense join issues an all-to-all "
         f"over {_flat_devices(devices)} ranks: {found} (group sizes "
         f"{entry['all_to_all_group_sizes']}, {entry['calls']} calls)")
    return found


def routed_memory_report(pg, devices, device="cpu") -> dict:
    """Record the gated channel programs: per program the worst collective
    operand (elements) and, on the card, the peak device bytes."""
    return {"n_pad": int(pg.n_pad), "devices": _flat_devices(devices),
            "programs": channel_programs(pg, devices, device)}


def check_routed_memory(n=180, M=8, tau=8, devices=8, balance="hash",
                        device="cpu") -> dict:
    """The acceptance gate: at D=8 no sharded channel may all-reduce or
    all-gather an operand of >= n_pad elements (all-to-all operands are
    the routed exchange itself and scale with the caps, not n)."""
    import torch.distributed as dist
    pg = _test_graph(n, M, tau, balance=balance, device=device)
    rep = routed_memory_report(pg, devices, device)
    ok = True
    for name, entry in rep["programs"].items():
        cell_ok = routed_ok(entry, pg.n_pad)
        ok &= cell_ok
        _log(dist.get_rank(),
             f"[shard_check] routed-memory {name}: worst all-reduce/"
             f"all-gather operand {replicated_elems(entry)} elems vs n_pad "
             f"{pg.n_pad} ({entry['calls']} calls){_peak_text(entry)}: "
             + ("OK" if cell_ok else "REPLICATED BUFFER"))
    rep["ok"] = bool(ok)
    return rep


def _level_verdict(entry, H, T, n_pad) -> tuple:
    two = two_levels_ok(entry, H, T)
    small = routed_ok(entry, n_pad)
    text = ("OK" if two and small else
            ("MISSING LEVEL" if not two else "REPLICATED BUFFER"))
    return two, small, text


def check_hier_levels(n=180, M=8, tau=8, hier=(2, 4), device="cpu") -> dict:
    """The 2-D gate: every gated channel program on a ``(H, T)`` mesh
    must issue all-to-alls in groups of size T (the intra-host leg) AND of
    size H (the cross-host leg), and no all-reduce / all-gather operand of
    >= n_pad elements."""
    import torch.distributed as dist
    H, T = hier
    pg = _test_graph(n, M, tau, device=device)
    rep = {"hier": [H, T], "n_pad": int(pg.n_pad), "programs": {}}
    ok = True
    for name, entry in channel_programs(pg, hier, device).items():
        two, small, text = _level_verdict(entry, H, T, pg.n_pad)
        rep["programs"][name] = dict(entry, two_levels=bool(two),
                                     no_replicated_buffer=bool(small))
        ok &= two and small
        _log(dist.get_rank(),
             f"[shard_check] hier-levels {name} @ {H}x{T}: all-to-all "
             f"group sizes {entry['all_to_all_group_sizes']}, worst "
             f"all-reduce/all-gather operand {replicated_elems(entry)} vs "
             f"n_pad {pg.n_pad}{_peak_text(entry)}: {text}")
    rep["ok"] = bool(ok)
    return rep


def check_gspmm_hier(n=180, M=8, tau=8, F=4, hier=(2, 4),
                     device="cpu") -> dict:
    """The vector-payload 2-D gate: a gSpMM join carrying an F-wide
    feature block (``gspmm_stats(..., "u_mul_e_sum")`` through
    ``apply_sharded``) on a ``(H, T)`` mesh must issue the same two
    all-to-all levels as the scalar channels, and no all-reduce /
    all-gather of a >= n_pad-element operand; dense and plan backends."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import exec as exec_mod
    from repro_torch.core import gspmm

    H, T = hier
    pg = _test_graph(n, M, tau, device=device)
    feats = torch.as_tensor(np.random.RandomState(0).randn(
        pg.M, pg.n_loc, F).astype(np.float32), device=device)
    rep = {"hier": [H, T], "F": int(F), "n_pad": int(pg.n_pad),
           "programs": {}}
    ok = True
    with record_collectives() as log:
        for name, backend in (("gspmm_dense", "dense"),
                              ("gspmm_plan", "pallas")):
            kinds = exec_mod.broadcast_plan_kinds(backend)

            def mk(g, be=backend):
                return log.during(lambda x: gspmm.gspmm_stats(
                    g, "u_mul_e_sum", x, backend=be))
            exec_mod.shard(pg, hier, kinds, device)
            entry = _program_entry(log, lambda: exec_mod.apply_sharded(
                pg, mk, (feats,), devices=hier, plan_kinds=kinds,
                device=device), device)
            two, small, text = _level_verdict(entry, H, T, pg.n_pad)
            rep["programs"][name] = dict(entry, two_levels=bool(two),
                                         no_replicated_buffer=bool(small))
            ok &= two and small
            _log(dist.get_rank(),
                 f"[shard_check] gspmm F={F} {name} @ {H}x{T}: all-to-all "
                 f"group sizes {entry['all_to_all_group_sizes']}, worst "
                 f"all-reduce/all-gather operand {replicated_elems(entry)} "
                 f"vs n_pad {pg.n_pad}{_peak_text(entry)}: {text}")
    rep["ok"] = bool(ok)
    return rep


def check_hier_caps(n=160, M=8, hier=(2, 4), device="cpu") -> bool:
    """Per-level cap overflow: the raw routed joins on a 2-D mesh with
    ``(cap1, cap2)`` caps far below the traffic (most lanes aim at one
    worker, so the destination is hot on the host axis too and the
    inter-host leg takes several rounds) must give the plain scatter /
    read bitwise (masked lanes exactly 0), sequential and pipelined: a
    cap is a round size, never a truncation."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import exec as exec_mod

    H, T = hier
    pg = _test_graph(n, M, tau=8, device=device)
    rng = np.random.RandomState(7)
    R = 33  # lanes per worker: column buckets far exceed an 8-lane cap
    t_np = np.where(
        rng.rand(pg.M, R) < 0.8,
        rng.randint(0, pg.n_loc, (pg.M, R)),          # hot: worker 0
        rng.randint(0, pg.n_pad, (pg.M, R))).astype(np.int32)
    m_np = rng.rand(pg.M, R) > 0.25
    t_np[:, ::5] = 0  # masked lanes alias a real hot vertex
    m_np[:, ::5] = False
    v_np = rng.randint(1, 1 << 20, (pg.M, R)).astype(np.int32)
    attr_np = rng.randint(1, 1 << 20, (pg.M, pg.n_loc)).astype(np.int32)
    targets, mask, vals, attr = (torch.as_tensor(a, device=device)
                                 for a in (t_np, m_np, v_np, attr_np))

    ident = np.iinfo(np.int32).max
    ref_sc = np.full(pg.n_pad + 1, ident, np.int32)
    np.minimum.at(ref_sc, np.where(m_np, t_np, pg.n_pad).reshape(-1),
                  v_np.reshape(-1))
    ref_sc = ref_sc[:pg.n_pad].reshape(pg.M, pg.n_loc)
    ref_ft = np.where(m_np, attr_np.reshape(-1)[t_np], 0)

    def mk_scatter(g):
        def fn(t, v, m):
            out = exec_mod._routed_scatter_combine(
                g, t.reshape(-1), v.reshape(-1), m.reshape(-1), "min",
                cap=(8, 8))
            return out.reshape(g.m_loc, g.n_loc), {}
        return fn

    def mk_fetch(g):
        def fn(a, t, m):
            got = exec_mod._routed_fetch(g, a, t.reshape(-1),
                                         m.reshape(-1), cap=(8, 8))
            return got.reshape(-1, t.shape[1]), {}
        return fn

    ok = True
    for pipe in (False, True):
        out_sc, _, _ = exec_mod.apply_sharded(
            pg, mk_scatter, (targets, vals, mask), devices=hier,
            pipeline=pipe, device=device)
        sc_ok = bool(np.array_equal(_host(out_sc), ref_sc))
        out_ft, _, _ = exec_mod.apply_sharded(
            pg, mk_fetch, (attr, targets, mask), devices=hier,
            pipeline=pipe, device=device)
        ft_ok = bool(np.array_equal(_host(out_ft), ref_ft))
        ok &= sc_ok and ft_ok
        tag = "pipeline" if pipe else "sequential"
        _log(dist.get_rank(),
             f"[shard_check] hier-caps @ {H}x{T} cap=(8,8) {tag}: "
             f"scatter {'OK' if sc_ok else 'MISMATCH'}, "
             f"fetch {'OK' if ft_ok else 'MISMATCH'}")
    return ok


def check_masked_lanes(n=160, M=8, devices=(8,), device="cpu") -> bool:
    """Masked request lanes must never leak into gathered values: the
    sharded Ch_req output equals the unsharded channel bitwise for dedup
    on AND off, and masked lanes hold exactly the fill (0), even when
    the masked target id aliases a real vertex; row-shaped (``gather``)
    and edge-shaped (``gather_edges`` on the csr adjacency)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import exec as exec_mod
    from repro_torch.core.channels import gather, gather_edges

    rank = dist.get_rank()
    ok = True
    pg = _test_graph(n, M, tau=None, layout="csr", device=device)
    rng = np.random.RandomState(3)
    vals = torch.as_tensor(rng.randn(pg.M, pg.n_loc).astype(np.float32)
                           + 1.0, device=device)  # 0 == masked fill only
    R = 17
    targets = rng.randint(0, pg.n_pad, (pg.M, R)).astype(np.int32)
    targets[:, ::3] = 0    # masked lanes deliberately alias vertex 0
    m_np = rng.rand(pg.M, R) > 0.4
    mask = torch.as_tensor(m_np, device=device)
    tj = torch.as_tensor(targets, device=device)

    for dedup in (True, False):
        ref = _host(gather(pg, vals, tj, mask, dedup=dedup)[0])
        masked_zero = bool((ref[~m_np] == 0).all())
        ok &= masked_zero
        for D in devices:
            def mk(g, dd=dedup):
                return lambda v, t, m: gather(g, v, t, m, dedup=dd)
            out, _, _ = exec_mod.apply_sharded(pg, mk, (vals, tj, mask),
                                               devices=D, device=device)
            same = bool(np.array_equal(_host(out), ref))
            ok &= same
            _log(rank, f"[shard_check] masked-lanes gather csr "
                 f"dedup={dedup} devices={D}: "
                 + ("OK" if same and masked_zero else "LEAK"))

    # the edge-shaped twin: targets and mask derived lane for lane from
    # the (device-sliced) adjacency, so the same formula runs identically
    # unsharded and per device
    def lanes(dst, emask):
        t = (dst * 37 + 13) % pg.n_pad     # arbitrary alias ids
        m = emask & ((dst * 31 + 7) % 5 > 1)
        return t, m
    for dedup in (True, False):
        def mk(g, dd=dedup):
            def fn(v):
                t, m = lanes(g.all_dst, g.all_mask)
                return gather_edges(g, v, t, m, dedup=dd)
            return fn
        ref = _host(mk(pg)(vals)[0])
        m_e = _host(lanes(pg.all_dst, pg.all_mask)[1])
        ok &= bool((ref[~m_e] == 0).all())
        for D in devices:
            out, _, _ = exec_mod.apply_sharded(pg, mk, (vals,), devices=D,
                                               device=device)
            out = _host(out)
            counts = np.diff(exec_mod.device_edge_bounds(pg, D)["all"])
            cap = out.shape[0] // _flat_devices(D)
            flat = np.concatenate([out[d * cap:d * cap + int(counts[d])]
                                   for d in range(_flat_devices(D))])
            same = bool(np.array_equal(flat, ref))
            ok &= same
            _log(rank, f"[shard_check] masked-lanes gather_edges "
                 f"dedup={dedup} devices={D}: " + ("OK" if same else "LEAK"))
    return ok


def run_controls(n=180, M=8, tau=8, hier=(2, 4), device="cpu") -> dict:
    """Each gate's predicate on a program built to violate it: ``{name:
    predicate}``, every value must be False.  ``routed_memory``: a step
    that all-gathers the (m_loc, n_loc) state; ``routed_memory_silent``:
    a step that issues no collective (a gate never passes vacuously);
    ``hier_levels``: the plan broadcast on the 1-D mesh of H*T ranks;
    ``all_to_all``: a step with no collective at all."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import exec as exec_mod

    H, T = hier
    D = H * T
    pg = _test_graph(n, M, tau, device=device)
    dense = _bcast_step("dense")

    def gathering(g):
        step = dense(g)

        def run(state, i):
            g.all_gather_rows(state)
            return step(state, i)
        return run

    def silent(g):
        def step(state, i):
            return state, torch.tensor(True), {}
        return step

    out = {}
    with record_collectives() as log:
        e = _program_entry(log, _run_steps(log, pg, gathering, D, (),
                                           device), device)
        out["routed_memory"] = routed_ok(e, pg.n_pad)
        e = _program_entry(log, _run_steps(log, pg, silent, D, (), device),
                           device)
        out["routed_memory_silent"] = routed_ok(e, pg.n_pad)
        out["all_to_all"] = has_all_to_all(e, D)
        kinds = exec_mod.broadcast_plan_kinds("pallas")
        e = _program_entry(log, _run_steps(log, pg, _bcast_step("pallas"),
                                           D, kinds, device), device)
        out["hier_levels"] = two_levels_ok(e, H, T) and routed_ok(
            e, pg.n_pad)
    _log(dist.get_rank(), "[shard_check] controls (each gate on a program "
         "that violates it; every gate must reject): " + ", ".join(
             f"{k}={'REJECTED' if not v else 'ACCEPTED'}"
             for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def _suite_cells(suite: str):
    """Matrix slices per suite: (algos, layouts, backends, devices,
    balance, pipeline) tuples."""
    if suite == "tier1":
        # one cell per join-family x regime: the pallas row covers every
        # algorithm at one-worker-per-device, the devices=2 cells pin the
        # general m_loc>1 collectives, split covers shard-crossing routes.
        # Every row also runs the same traffic through the hierarchical
        # (2,4) mesh against the SAME sequential single-device reference,
        # which pins 2-D == 1-D bitwise / integer-exact.  The
        # pipeline=True rows hold the double-buffered executor to the
        # identical parity contract.
        return [
            (ALGOS, ("csr",), ("pallas",), (8, (2, 4)), "hash", False),
            (ALGOS, ("csr",), ("pallas",), (8, (2, 4)), "hash", True),
            (("sv",), ("csr",), ("dense",), (2, (2, 4)), "hash", False),
            (("sv",), ("csr",), ("dense",), (2, (2, 4)), "hash", True),
            (("hashmin",), ("csr",), ("pallas",), (8, (2, 4)), "split",
             False),
            (("hashmin",), ("csr",), ("pallas",), (8, (2, 4)), "split",
             True),
            # the locality refinement and mega-hub vertex-cut partitioner
            # modes ride the same csr/pallas row
            (("hashmin",), ("csr",), ("pallas",), (8, (2, 4)),
             "edges+refine", False),
            (("hashmin",), ("csr",), ("pallas",), (8, (2, 4)),
             "edges+refine", True),
            (("hashmin",), ("csr",), ("pallas",), (8, (2, 4)),
             "vertex-cut", False),
            (("hashmin",), ("csr",), ("pallas",), (8, (2, 4)),
             "vertex-cut", True),
        ]
    if suite == "hier":
        # every algorithm on every (hosts, per_host) factorization of 8
        # devices, sequential and pipelined, against the sequential
        # single-device reference
        return [
            (ALGOS, ("csr",), ("pallas",), ((1, 8), (2, 4), (4, 2)),
             "hash", False),
            (ALGOS, ("csr",), ("pallas",), ((1, 8), (2, 4), (4, 2)),
             "hash", True),
        ]
    if suite == "full":
        cells = []
        for pipe in (False, True):
            cells += [
                (ALGOS, ("padded", "csr"), ("dense", "pallas"), (1, 2, 8),
                 "hash", pipe),
                (ALGOS, ("csr",), ("dense", "pallas"),
                 (1, 2, 8, (2, 4)), "edges", pipe),
                (ALGOS, ("csr",), ("dense", "pallas"),
                 (1, 2, 8, (2, 4)), "split", pipe),
                (ALGOS, ("csr",), ("pallas",), (1, 8, (2, 4)),
                 "edges+refine", pipe),
                (ALGOS, ("csr",), ("pallas",), (1, 8, (2, 4)),
                 "vertex-cut", pipe),
            ]
        return cells
    raise ValueError(f"unknown suite {suite!r}")


def _parse_devices(spec: str):
    """``8`` -> 8 (1-D mesh); ``2x4`` -> (2, 4) (hierarchical mesh)."""
    if "x" in spec:
        h, t = spec.split("x", 1)
        return (int(h), int(t))
    return int(spec)


def world_jobs(args) -> dict:
    """``{world size: {"matrix": [run_matrix kwargs], "gates": bool,
    "all_to_all": devices or None}}``: every cell and gate, on the spawn
    of the world size it needs (the suites' gates and their controls on
    8 ranks)."""
    worlds = {}

    def world(W):
        return worlds.setdefault(W, {"matrix": [], "gates": False,
                                     "all_to_all": None})
    if args.suite:
        rows = _suite_cells(args.suite)
    else:
        rows = [(tuple(args.algos), tuple(args.layouts), ("dense", "pallas"),
                 tuple(args.devices), bal, args.pipeline)
                for bal in args.balance]
    for algos, layouts, backends, devs, bal, pipe in rows:
        by_world = {}
        for d in devs:
            by_world.setdefault(_flat_devices(d), []).append(d)
        for W, ds in by_world.items():
            world(W)["matrix"].append(dict(
                algos=algos, layouts=layouts, backends=backends,
                device_counts=tuple(ds), n=args.n, M=args.workers,
                balance=bal, pipeline=pipe))
    if args.suite:
        world(8)["gates"] = True
    elif not args.skip_hlo_check:
        d = max(args.devices, key=_flat_devices)
        world(_flat_devices(d))["all_to_all"] = d
    return dict(sorted(worlds.items()))


def run_world(jobs: dict, args, device) -> tuple:
    """Every job of one world on this rank; (report, ok) on rank 0."""
    report = {"cells": {}, "crossness": {}, "reference": {}}
    ok = True
    for kw in jobs["matrix"]:
        rep, bok = run_matrix(device=device, **kw)
        ok &= bok
        for k in ("cells", "crossness", "reference"):
            report[k].update(rep[k])
    a2a = 8 if jobs["gates"] else jobs["all_to_all"]
    if a2a is not None:
        report["all_to_all"] = check_all_to_all(
            n=args.n, M=args.workers, devices=a2a, device=device)
        ok &= report["all_to_all"]
    if jobs["gates"]:
        report["routed_memory"] = check_routed_memory(
            n=args.n, M=args.workers, devices=8, device=device)
        ok &= report["routed_memory"]["ok"]
        report["masked_lanes_ok"] = check_masked_lanes(
            M=args.workers,
            devices=(1, 8) if args.suite == "full" else (8,), device=device)
        ok &= report["masked_lanes_ok"]
        report["hier_levels"] = check_hier_levels(
            n=args.n, M=args.workers, hier=(2, 4), device=device)
        ok &= report["hier_levels"]["ok"]
        report["hier_caps_ok"] = check_hier_caps(M=args.workers, hier=(2, 4),
                                                 device=device)
        ok &= report["hier_caps_ok"]
        for F in (4, 1):
            key = "gspmm_hier" if F == 4 else f"gspmm_hier_f{F}"
            report[key] = check_gspmm_hier(n=args.n, M=args.workers, F=F,
                                           hier=(2, 4), device=device)
            ok &= report[key]["ok"]
        report["controls"] = run_controls(n=args.n, M=args.workers,
                                          device=device)
        ok &= not any(report["controls"].values())
    return report, bool(ok)


def _jsonable(x):
    import numpy as np
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _rank_main(rank: int, W: int, backend: str, device_kind: str,
               init_method: str, argv, jobs: dict, out_path: str) -> None:
    """One rank of a world's spawn: join the group, run the world's jobs;
    rank 0 writes its report (and its kernel launches) to ``out_path``."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.segment_combine import kernel
    from repro_torch.launch import mesh as meshlib

    args = build_parser().parse_args(argv)
    if device_kind == "cuda":
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=init_method, world_size=W, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        counter = kernel.segment_combine_blocks
        counter.launches = counter.launches_vec = 0   # the world starts
        report, ok = run_world(jobs, args, device)
        launches = {"scalar": counter.launches,       # ... and ends here
                    "vector": counter.launches_vec}
        if rank == 0:
            report.update(ok=ok, world=W, backend=backend,
                          device=str(device), launches=launches)
            Path(out_path).write_text(json.dumps(_jsonable(report)))
    finally:
        meshlib.destroy()


def world_backend(W: int, device_kind: str) -> str:
    """NCCL with a card a rank where there are W cards, else gloo (every
    rank on cuda:0 on the card, or on the CPU)."""
    import torch
    if device_kind == "cuda" and torch.cuda.device_count() >= W:
        return "nccl"
    return "gloo"


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--suite", choices=("tier1", "hier", "full"),
                    default=None,
                    help="consolidated profiles (matrix + collective, "
                         "memory and masked-lane gates and the gates' "
                         "controls); overrides the explicit matrix flags")
    # 1 = one rank, 2 = several workers per rank (m_loc > 1), 8 = one
    # worker per rank, HxT (e.g. 2x4) = the (host, device) mesh
    ap.add_argument("--devices", type=_parse_devices, nargs="+",
                    default=[1, 2, 8])
    ap.add_argument("--algos", nargs="+", default=list(ALGOS))
    ap.add_argument("--n", type=int, default=180)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--balance", nargs="+", default=["hash"],
                    help="partition balance modes to sweep (hash / edges "
                         "/ edges+refine / split / vertex-cut; split runs "
                         "csr cells only)")
    ap.add_argument("--layouts", nargs="+", default=["padded", "csr"])
    ap.add_argument("--pipeline", action="store_true",
                    help="run the sharded side through the "
                         "double-buffered pipeline (explicit-matrix mode; "
                         "the suites sweep both on their own)")
    ap.add_argument("--skip-hlo-check", action="store_true",
                    help="skip the dense all-to-all collective gate of the "
                         "explicit matrix")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="the ranks' devices: cuda (the default; raises "
                         "when no card is visible) or cpu (gloo)")
    ap.add_argument("--out", default="")
    return ap


def main(argv=None) -> None:
    import torch
    from repro_torch.launch.graph_run import rendezvous, spawn_ranks

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    kind = args.device
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible")
    report = {"cells": {}, "crossness": {}, "reference": {}, "worlds": {}}
    ok = True
    for W, jobs in world_jobs(args).items():
        backend = world_backend(W, kind)
        print(f"[shard_check] world {W}: {backend}, "
              + (f"{W} ranks on the CPU" if kind == "cpu" else
                 ("a card a rank" if backend == "nccl"
                  else f"{W} ranks on cuda:0")), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "report.json"
            spawn_ranks(_rank_main, (W, backend, kind, rendezvous(tmp),
                                     argv, jobs, str(out)), W,
                        SPAWN_TIMEOUT_S)
            rep = json.loads(out.read_text())
        for k in ("cells", "crossness", "reference"):
            report[k].update(rep.pop(k))
        report["worlds"][str(W)] = {k: rep[k] for k in (
            "ok", "backend", "device", "launches")}
        report.update({k: v for k, v in rep.items()
                       if k not in ("ok", "world", "backend", "device",
                                    "launches")})
        ok &= rep["ok"]
        if not ok:
            break
    report["ok"] = bool(ok)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2))
    print(f"[shard_check] {'ALL CELLS OK' if ok else 'PARITY VIOLATIONS'}",
          flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

"""The port's program spans (``navier_stokes_tpu_torch/utils/tracing.py``)
on the CPU.

* With no profiler recording, a span is the shared null context: nothing
  is recorded and ``record_function`` is never entered.
* Under ``torch.profiler``, one f32 SIMPLE step of the 3D MCS channel at
  maxh 0.6 and one HDG initial Stokes solve on a 24-tet box give the span
  trees the benchmark's readers expect (``perfbench/metrics/_program.py``):
  ``step`` over ``convection``, ``mstar_cg`` and ``projection``, each CG
  its ``cg.apply`` / ``cg.pre`` / ``cg.read`` spans, ``chebyshev`` under
  the projection's operator, ``twolevel`` under its preconditioner;
  ``stokes_solve`` over ``lanczos`` and ``bpcg``.  Parents and root ids are
  checked, ``cg.read`` counts iterations + 1 per CG and the solver roots
  carry their iterations; MINRES and BPCG v1 on small dense systems too.
* Each buffered span holds its ``ns:`` profiler range within 20 us, and
  their edges agree within 20 us at the median.
* The step's state and the solve's solution are ``torch.equal`` with
  tracing on and off.

The step runs on the straight channel at loose CG tolerances (1e-2) to
keep the file short; the card test of the profiler's clock is in
``tests/test_torch_cuda.py``.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from torch.profiler import ProfilerActivity, profile

from navier_stokes_tpu_torch.flagship import build_model
from navier_stokes_tpu_torch.mesh.generators import (
    extrude_to_tets,
    rectangle_mesh,
)
from navier_stokes_tpu_torch.models import NavierStokesHDG3D
from navier_stokes_tpu_torch.precond.chebyshev import (
    chebyshev_preconditioner,
)
from navier_stokes_tpu_torch.solvers.bpcg import (
    bramble_pasciak_cg,
    bramble_pasciak_cg_opt,
)
from navier_stokes_tpu_torch.solvers.cg import cg
from navier_stokes_tpu_torch.solvers.minres import minres
from navier_stokes_tpu_torch.utils import tracing

TOL_NS = 20_000  # a buffered span against its profiler range
STEP_TOL = 1e-2  # the step's M* and projection CG tolerances


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for PyTorch and one for numpy's BLAS."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _traced(fn):
    """fn() under a CPU profiler: (its result, the spans it recorded, the
    profiler's ``ns:`` ranges by name in order of start)."""
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = tracing.records()
    tracing.reset()
    ranges = {}
    for ev in sorted(prof.profiler.kineto_results.events(),
                     key=lambda e: e.start_ns()):
        if ev.name().startswith(tracing.PREFIX):
            ranges.setdefault(ev.name()[len(tracing.PREFIX):], []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out, recs, ranges


def _box_mesh():
    """The 24-tet box of the HDG smoke test (0.5 x 1 x 0.5, inlet at x = 0,
    outlet at x = 1)."""
    mesh = extrude_to_tets(rectangle_mesh(0.5, 1.0, 1.0),
                           np.linspace(0, 0.5, 2))
    tol = 1e-9
    mesh.tag_boundary_by_predicate("inlet",
                                   lambda p: np.abs(p[:, :, 0]) < tol)
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < tol)
    rest = np.setdiff1d(mesh.boundary_facets, np.concatenate(
        [mesh.boundary_tags["inlet"], mesh.boundary_tags["outlet"]]))
    mesh.boundary_tags["wall"] = rest.astype(np.int32)
    return mesh


def _box_uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = (16 * p[:, 1] * (1 - p[:, 1]) * p[:, 2] * (0.5 - p[:, 2])
                 / 0.25)
    return out


@pytest.fixture(scope="module")
def mcs_step(one_torch_thread):
    m = build_model(0.6, device="cpu", dtype=torch.float32, curved=False)
    step = m.make_step_fn(project_tol=STEP_TOL, mstar_tol=STEP_TOL)
    u0 = m.u.clone()
    u_off = step(u0)
    counts_off = dict(m.last_iterations)
    u_on, recs, ranges = _traced(lambda: step(u0))
    return dict(u_off=u_off, u_on=u_on, counts_off=counts_off,
                counts_on=dict(m.last_iterations), recs=recs, ranges=ranges)


@pytest.fixture(scope="module")
def hdg_solve(one_torch_thread):
    m = NavierStokesHDG3D(_box_mesh(), nu=0.01, inflow="inlet",
                          outflow="outlet", wall="wall", uin=_box_uin,
                          timestep=2e-3, order=2, device="cpu")
    res_off = m.SolveInitial(tol=1e-8)
    res_on, recs, ranges = _traced(lambda: m.SolveInitial(tol=1e-8))
    return dict(res_off=res_off, res_on=res_on, recs=recs, ranges=ranges)


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def _check_tree(recs):
    """Indices, parents and roots are consistent and every span nests in
    its parent."""
    for i, r in enumerate(recs):
        assert r.end is not None and r.start <= r.end
        if r.parent is None:
            assert r.root == i
        else:
            p = recs[r.parent]
            assert r.parent < i and r.root == p.root
            assert p.start <= r.start and r.end <= p.end


def _cg_checks(recs, i):
    """The CG span ``i``: its children and its read count."""
    kids = Counter(r.name for r in _children(recs, i))
    its = recs[i].attrs["iterations"]
    assert kids["cg.read"] == its + 1
    assert kids["cg.apply"] == its
    assert kids["cg.pre"] == its + 1
    assert set(kids) == {"cg.read", "cg.apply", "cg.pre"}
    return its


def test_nothing_recorded_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tracing.reset()
    assert tracing.span("a") is tracing.span("b", iterations=3)
    with tracing.span("a") as sp:
        sp.set(iterations=1)
    gen = torch.Generator().manual_seed(0)
    n, m = 12, 4
    Q = torch.randn(n, n, generator=gen, dtype=torch.float64)
    A = Q @ Q.T + n * torch.eye(n, dtype=torch.float64)
    Bm = torch.randn(m, n, generator=gen, dtype=torch.float64)
    f = torch.randn(n, generator=gen, dtype=torch.float64)
    g = torch.randn(m, generator=gen, dtype=torch.float64)
    cg(lambda x: A @ x, f, tol=1e-10)
    minres(lambda x: A @ x, f, tol=1e-10)
    bramble_pasciak_cg_opt(lambda x: A @ x, lambda x: Bm @ x,
                           lambda p: Bm.T @ p,
                           lambda x: x / A.diagonal(), lambda p: p, f, g,
                           tol=1e-8, lanczos_iterations=8)
    cheb = chebyshev_preconditioner(lambda x: A @ x,
                                    lambda x: x / A.diagonal(), f)
    cheb(f)
    assert tracing.records() == []


def test_traced_and_wrap():
    """``traced`` and ``wrap`` with no profiler: the function's own result,
    the operator itself, nothing recorded; under one: the root span with
    the result's ``iterations`` and the wrapped operator inside it."""
    class Result:
        iterations = 7

    @tracing.traced("solver")
    def solve(op, x):
        op = tracing.wrap("solver.apply", op)
        out = Result()
        out.x = op(op(x))
        return out

    def double(x):
        return 2 * x

    tracing.reset()
    assert tracing.wrap("solver.apply", double) is double
    assert solve(double, 3).x == 12 and solve.__name__ == "solve"
    assert tracing.records() == []
    out, recs, ranges = _traced(lambda: solve(double, 3))
    assert out.x == 12
    _check_tree(recs)
    assert [(r.name, r.parent, r.attrs) for r in recs] == [
        ("solver", None, {"iterations": 7}), ("solver.apply", 0, {}),
        ("solver.apply", 0, {})]
    assert {k: len(v) for k, v in ranges.items()} == {"solver": 1,
                                                     "solver.apply": 2}


def test_spans_past_the_cap_are_counted(monkeypatch):
    """Past ``MAX_RECORDS`` spans are counted by ``dropped`` from the
    first one's start, not kept, until ``reset``; a closed span holds no
    profiler range."""
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tracing.span("kept"):
                pass
        assert tracing.dropped() == (0, None)
        for _ in range(2):
            with tracing.span("lost"):
                pass
    recs = tracing.records()
    n, first = tracing.dropped()
    assert [r.name for r in recs] == ["kept"] * 3 and n == 2
    assert recs[-1].end <= first
    assert all(r._rf is None for r in recs)
    tracing.reset()
    assert tracing.dropped() == (0, None) and tracing.records() == []


def test_step_span_tree(mcs_step):
    recs = mcs_step["recs"]
    _check_tree(recs)
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["step"]
    top = Counter(r.name for r in _children(recs, roots[0]))
    assert top == {"convection": 1, "mstar_cg": 1, "projection": 1}
    by_name = {}
    for i, r in enumerate(recs):
        by_name.setdefault(r.name, []).append(i)
    # M*: one CG under mstar_cg; projection: one CG, and the last
    # Chebyshev apply (the velocity correction) under the projection
    (mstar,) = by_name["mstar_cg"]
    (proj,) = by_name["projection"]
    cgs = by_name["cg"]
    assert [recs[i].parent for i in cgs] == [mstar, proj]
    its = [_cg_checks(recs, i) for i in cgs]
    counts = mcs_step["counts_on"]
    assert its == [counts["mstar"], counts["project"]]
    cheb_parents = Counter(recs[recs[i].parent].name
                           for i in by_name["chebyshev"])
    assert cheb_parents == {"cg.apply": counts["project"], "projection": 1}
    assert all(recs[recs[i].parent].parent == cgs[1]
               for i in by_name["twolevel"])
    assert len(by_name["twolevel"]) == counts["project"] + 1
    # no span opens inside a Chebyshev apply or a host read
    inner = {"chebyshev", "twolevel", "cg.read", "convection"}
    assert not [r for r in recs if r.parent is not None
                and recs[r.parent].name in inner]


def test_solve_span_tree(hdg_solve):
    recs = hdg_solve["recs"]
    _check_tree(recs)
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["stokes_solve"]
    top = _children(recs, roots[0])
    assert [r.name for r in top] == ["lanczos", "bpcg"]
    lz, bp = (recs.index(r) for r in top)
    lanczos = Counter(r.name for r in _children(recs, lz))
    assert lanczos == {"lanczos.apply": 40, "lanczos.pre": 41,
                       "lanczos.read": 80}
    its = hdg_solve["res_on"].iterations
    assert recs[bp].attrs == {"iterations": its}
    kids = Counter(r.name for r in _children(recs, bp))
    # v2 runs its + 1 loop passes: A, BT, preA, B, preM and one read each,
    # beside four A, three B, one BT, three preA, two preM and one read
    # ahead of the loop
    assert kids == {"bpcg.A": its + 5, "bpcg.B": its + 4,
                    "bpcg.BT": its + 2, "bpcg.preA": its + 4,
                    "bpcg.preM": its + 3, "bpcg.read": its + 2}
    assert not [r for r in recs if r.parent is not None
                and recs[r.parent].name.startswith("bpcg.")]


def test_minres_and_bpcg_v1_span_trees():
    gen = torch.Generator().manual_seed(1)
    n, m = 16, 5
    Q = torch.randn(n, n, generator=gen, dtype=torch.float64)
    A = Q @ Q.T + n * torch.eye(n, dtype=torch.float64)
    Bm = torch.randn(m, n, generator=gen, dtype=torch.float64)
    f = torch.randn(n, generator=gen, dtype=torch.float64)
    g = torch.randn(m, generator=gen, dtype=torch.float64)

    res, recs, _ = _traced(lambda: minres(lambda x: A @ x, f, tol=1e-10))
    _check_tree(recs)
    assert recs[0].name == "minres" and recs[0].parent is None
    assert recs[0].attrs == {"iterations": res.iterations}
    kids = Counter(r.name for r in _children(recs, 0))
    assert kids == {"minres.apply": res.iterations,
                    "minres.pre": res.iterations + 1,
                    "minres.read": 2 * res.iterations + 1}

    res, recs, _ = _traced(lambda: bramble_pasciak_cg(
        lambda x: A @ x, lambda x: Bm @ x, lambda p: Bm.T @ p,
        lambda x: x / A.diagonal(), lambda p: p, f, g, tol=1e-8,
        lanczos_iterations=8))
    _check_tree(recs)
    # the scaling's Lanczos, run by the solve itself, lies under its root
    assert [r.name for r in recs if r.parent is None] == ["bpcg"]
    bp = 0
    its = recs[bp].attrs["iterations"]
    assert its == res.iterations
    kids = Counter(r.name for r in _children(recs, bp))
    assert kids["lanczos"] == 1
    assert kids["bpcg.read"] == its + 1
    assert kids["bpcg.preA"] == kids["bpcg.preM"] == its + 1
    assert set(kids) == {"lanczos", "bpcg.A", "bpcg.B", "bpcg.BT",
                         "bpcg.preA", "bpcg.preM", "bpcg.read"}


@pytest.mark.parametrize("which", ["mcs_step", "hdg_solve"])
def test_spans_agree_with_profiler_ranges(which, request):
    """Each buffered span holds its ``ns:`` range to within TOL_NS at both
    edges (the buffered start is read just before the range opens, the
    end just after it closes, so a clock offset beyond TOL_NS either way
    breaks this for every span), and the edges lie within TOL_NS of each
    other at the median.  The profiler's own entry stalls for 25-100 us on
    a few spans in a thousand on the CPU, late inside the buffered span."""
    run = request.getfixturevalue(which)
    recs, ranges = run["recs"], run["ranges"]
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    assert set(by_name) == set(ranges)
    lead, lag = [], []
    for name, spans in by_name.items():
        assert len(ranges[name]) == len(spans)
        for r, (s, e) in zip(spans, ranges[name]):
            assert r.start - TOL_NS <= s <= e <= r.end + TOL_NS
            lead.append(s - r.start)
            lag.append(r.end - e)
    assert abs(np.median(lead)) <= TOL_NS
    assert abs(np.median(lag)) <= TOL_NS


def test_tracing_changes_no_result(mcs_step, hdg_solve):
    assert mcs_step["counts_on"] == mcs_step["counts_off"]
    assert torch.equal(mcs_step["u_on"], mcs_step["u_off"])
    on, off = hdg_solve["res_on"], hdg_solve["res_off"]
    assert on.iterations == off.iterations
    assert all(torch.equal(a, b) for a, b in zip(on.x, off.x))

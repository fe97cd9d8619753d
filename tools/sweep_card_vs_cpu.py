"""Where the port's 3D MCS Reynolds-number ensemble on the card departs from
the port on the CPU: chip_smoke.py's ``[sweep]`` ensemble at maxh 0.35
(the straight ``channel_with_cylinder_mesh_3d``, order 2, nu0 = 1e-3, dt =
2e-3, from u = u_bc with the JAX model's Chebyshev bounds), taken apart
step by step.

``run`` advances the chosen members of geomspace(1e-3, 1e-2, 8) through
``make_viscosity_step_mcs`` in one variant of the element products and
keeps, per member step, the M* right-hand side b, M* b, the M* CG's
relative error history and count, its solution, the projection count and
the state (an npz).  The variants:

  card        the port on the card (kernel 8 in float64)
  card-plain  the card with ``batched_local_matvec_plain`` in place of
              kernel 8 wherever the step reaches it
  cpu         the port on the CPU (the plain products)
  cpu-split   the CPU with every element product summed as two halves of
              the columns: another float64 summation order, no other change
  card-f32    the control: the step's nu-split and mass applies
              (``elem_apply_multi``) in float32, as before its repair

``terms`` keeps, on the variant's device, the terms of the first step's
M* right-hand side at u = u_bc (the convection, each nu-split table's and
the mass's apply, f, the free mask), the convection's tables (per row
sums of |entries|) and its intermediates (the traces, u.n, the upwind
values, the element and facet contributions); ``compare-terms`` prints two
such files against each other, term by term.

``--jax-bases`` builds the model with the JAX host's element-interior
BDM_2 functions (chip_smoke.py's ``carried_cell_bases``,
tools/jax_bdm2_cell_bases.npz).

``jax`` prints each run's members after their last step against the JAX
numbers chip_smoke.py holds the card to (SWEEP_SMALL_JAX at M* tol 1e-4,
SWEEP_TIGHT_JAX at 1e-10): relative max |u|, ||u_i - u_0||, ||u_i -
u_bc|| and the M* counts.

``compare`` prints each run against a reference run entry by entry (max
|d| over max |reference|, and the relative 2-norm), the CG counts and the
first iteration at which the error histories part by more than 1e-6
relative.

    python3 tools/sweep_card_vs_cpu.py run --variant card --out a.npz \\
        [--members 0,1,7] [--steps 2] [--mstar-tol 1e-4] [--jax-bases]
    python3 tools/sweep_card_vs_cpu.py compare ref.npz a.npz [b.npz ...]
    python3 tools/sweep_card_vs_cpu.py jax a.npz [b.npz ...]
    python3 tools/sweep_card_vs_cpu.py terms --variant card --out t.npz
    python3 tools/sweep_card_vs_cpu.py compare-terms ref.npz t.npz
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAXH, MEMBERS = 0.35, 8
# the JAX model's Chebyshev bounds at maxh 0.35 (chip_smoke.py's
# SWEEP_SMALL_JAX, from tools/jax_sweep_reference.py)
CHEB_BOUNDS = (0.1336248977269488, 6.68124488634744)
VARIANTS = ("card", "card-plain", "cpu", "cpu-split", "card-f32")


def patch_products(variant):
    """Swap the element products of the step for ``variant``."""
    import torch

    from navier_stokes_tpu_torch.ops import faceblock, local_mv

    if variant in ("card", "cpu"):
        return
    if variant == "card-f32":
        orig = faceblock.FaceBlockLayout.elem_apply_multi

        def f32_multi(self, mats_and_scales):
            apply = orig(self, [(torch.as_tensor(A).float(), c)
                                for A, c in mats_and_scales])
            return lambda u: apply(u.float()).double()

        faceblock.FaceBlockLayout.elem_apply_multi = f32_multi
        return
    if variant == "card-plain":
        product = local_mv.batched_local_matvec_plain
    else:  # cpu-split
        def product(A, x):
            h = A.shape[2] // 2
            return (torch.einsum("eij,ej->ei", A[:, :, :h], x[:, :h])
                    + torch.einsum("eij,ej->ei", A[:, :, h:], x[:, h:]))
    import importlib
    for name in ("ops.faceblock", "ops.assembly", "models.navier_stokes_mcs",
                 "precond.multicolor", "precond.jacobi"):
        mod = importlib.import_module(f"navier_stokes_tpu_torch.{name}")
        mod.batched_local_matvec = product


def _model(args, build_model, device):
    if not args.jax_bases:
        return build_model(MAXH, curved=False, device=device)
    from chip_smoke import carried_cell_bases

    with carried_cell_bases(os.path.join(
            ROOT, "tools", "jax_bdm2_cell_bases.npz")) as carried:
        m = build_model(MAXH, curved=False, device=device)
    print(f"JAX's element-interior functions carried into "
          f"{carried.combos} combos: off the port's own null space by "
          f"{carried.off_span:.2e}, apart from its own functions by "
          f"{carried.apart:.2e}", flush=True)
    return m


def run(args):
    import torch

    from navier_stokes_tpu_torch.flagship import build_model
    from navier_stokes_tpu_torch.parallel import sweep

    device = "cuda" if args.variant.startswith("card") else "cpu"
    patch_products(args.variant)
    t0 = time.perf_counter()
    m = _model(args, build_model, device)
    m.load_state(cheb_bounds=CHEB_BOUNDS)
    recs = []
    real_cg = sweep.cg

    def recording_cg(A, b, pre=None, **kw):
        res = real_cg(A, b, pre=pre, **kw)
        recs.append(dict(b=b.double().cpu().numpy(),
                         Ab=A(b).double().cpu().numpy(),
                         errors=res.errors[:res.iterations + 1],
                         x=res.x.double().cpu().numpy()))
        return res

    sweep.cg = recording_cg
    step = sweep.make_viscosity_step_mcs(m, args.mstar_tol)
    nus = np.geomspace(1e-3, 1e-2, MEMBERS)
    out = {}
    for i in args.members:
        u = m.u
        for k in range(args.steps):
            t1 = time.perf_counter()
            u = step(u, torch.tensor(nus[i], dtype=m.dtype, device=m.device))
            r = recs.pop()
            key = f"m{i}s{k}"
            out.update({f"{key}_{n}": v for n, v in r.items()})
            out[f"{key}_u"] = u.double().cpu().numpy()
            out[f"{key}_counts"] = np.array(
                [m.last_iterations["mstar"], m.last_iterations["project"]])
            print(f"{args.variant} member {i} nu={nus[i]:.6g} step {k}: M* "
                  f"CG {m.last_iterations['mstar']}, projection CG "
                  f"{m.last_iterations['project']}, max |u| "
                  f"{float(u.abs().max()):.10f}, "
                  f"{time.perf_counter() - t1:.2f} s", flush=True)
    out["u_bc"] = m.u_bc.double().cpu().numpy()
    np.savez(args.out, variant=args.variant, mstar_tol=args.mstar_tol,
             **out)
    print(f"{args.variant}: {time.perf_counter() - t0:.1f} s in all, "
          f"wrote {args.out}", flush=True)


def terms(args):
    import torch

    from navier_stokes_tpu_torch.flagship import build_model
    from navier_stokes_tpu_torch.parallel import sweep

    device = "cuda" if args.variant.startswith("card") else "cpu"
    patch_products(args.variant)
    m = _model(args, build_model, device)
    m.load_state(cheb_bounds=CHEB_BOUNDS)
    step = sweep.make_viscosity_step_mcs(m)
    u = m.u
    nhd = m.V.ndof
    out = {"u_bc": u, "f": m.f, "free": m.free.double(),
           "conv": m.convection(u)}
    for name, A in step.tables.items():
        out[f"apply_{name}"] = m.fb.elem_apply_multi([(A, None)])(u)
    # the convection's closure: its tables and index maps, by name
    conv = m._build_convection()
    cells = dict(zip(conv.__code__.co_freevars,
                     (c.cell_contents for c in conv.__closure__)))
    for name, v in cells.items():
        if torch.is_tensor(v):
            v = v.double() if v.dtype != torch.bool else v.double()
            out[f"tab_{name}"] = (v.abs().reshape(v.shape[0], -1).sum(1)
                                  if v.dim() > 1 else v)
    c = cells
    uh = u[:nhd]
    ne, nq, nfacet = c["ne"], c["nq"], c["nfacet"]
    nq2 = c["nq2"]
    ue = uh[c["eldofs"]]
    uq = torch.bmm(c["val_t"], ue[:, :, None]).reshape(ne, nq, 3)
    uu = (c["w_vol"][:, :, None, None] * uq[:, :, :, None]
          * uq[:, :, None, :]).reshape(ne, nq * 9, 1)
    uL = torch.bmm(c["trace_L"], uh[c["dofs_L"]][:, :, None]).reshape(
        nfacet, nq2, 3)
    uR_in = torch.bmm(c["trace_R"], uh[c["dofs_R"]][:, :, None]).reshape(
        nfacet, nq2, 3)
    uR = torch.where(c["has_right_t"][:, None, None], uR_in, c["ub_t"])
    un = torch.einsum("fqc,fc->fq", uL, c["n_g_t"])
    u_up = torch.where(un[..., None] > 0, uL, uR)
    flux = ((c["w_face"] * un)[..., None] * u_up).reshape(nfacet, 1,
                                                          nq2 * 3)
    out.update(uq=uq, fe_vol=torch.bmm(c["grad_t"], uu).reshape(ne, -1),
               uL=uL, uR=uR, un=un, u_up=u_up,
               fe_L=-torch.bmm(flux, c["trace_L"]).reshape(nfacet, -1),
               fe_R=torch.bmm(flux, c["trace_R"]).reshape(nfacet, -1))
    np.savez(args.out, variant=args.variant,
             **{k: v.double().cpu().numpy() for k, v in out.items()})
    print(f"{args.variant}: wrote {args.out}", flush=True)


def compare_terms(args):
    ref, got = np.load(args.ref), np.load(args.runs[0])
    print(f"== terms of {got['variant']} against {ref['variant']}")
    for k in ref.files:
        if k == "variant":
            continue
        a, b = ref[k], got[k]
        if a.shape != b.shape:
            print(f"  {k}: shape {b.shape}, ref {a.shape}")
            continue
        d = np.abs(a - b).reshape(len(a), -1).max(1) if a.ndim else abs(a - b)
        scale = max(float(np.abs(a).max()), 1e-300)
        apart = np.nonzero(d > 1e-9 * scale)[0] if a.ndim else []
        print(f"  {k} {a.shape}: max |d| {float(np.max(d)):.3e} of max "
              f"|ref| {scale:.3e}; {len(apart)} rows apart by more than "
              f"1e-9 of it" + (f", first {list(apart[:12])}"
                               if len(apart) else ""))


def against_jax(args):
    import chip_smoke as cs

    for path in [args.ref] + args.runs:
        got = np.load(path)
        tol = float(got["mstar_tol"])
        jax = (cs.SWEEP_SMALL_JAX["members"] if tol == 1e-4
               else cs.SWEEP_TIGHT_JAX if tol == cs.SWEEP_TIGHT_CG else None)
        if jax is None:
            print(f"== {path}: no JAX numbers at M* tol {tol:g}")
            continue
        steps = [int(k[3:].split("_")[0]) for k in got.files
                 if k.startswith("m0s")]
        if not steps:
            print(f"== {path}: member 0 not run")
            continue
        last = max(steps)
        print(f"== {got['variant']} (M* tol {tol:g}) against JAX, after "
              f"step {last + 1}")
        u0, ub = got[f"m0s{last}_u"], got["u_bc"]
        for k in sorted(f for f in got.files
                        if f.endswith(f"s{last}_u") and f[0] == "m"):
            i = int(k[1:].split("s")[0])
            u, j = got[k], jax[i]
            rel = {"max |u|": (np.abs(u).max(), j["max_abs_u"]),
                   "||u_i - u_0||": (np.linalg.norm(u - u0), j["dist_u0"]),
                   "||u_i - u_bc||": (np.linalg.norm(u - ub),
                                      j["dist_u_bc"])}
            counts = [int(got[f"m{i}s{s}_counts"][0])
                      for s in range(last + 1)]
            print(f"  member {i}: " + ", ".join(
                f"{n} {abs(a - b) / b:.2e}" if b else f"{n} -"
                for n, (a, b) in rel.items())
                + f"; M* CG {counts} (JAX {j['mstar']})")


def _d(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    scale = max(float(np.abs(ref).max()), 1e-300)
    return (float(np.abs(got - ref).max()) / scale,
            float(np.linalg.norm(got - ref)
                  / max(float(np.linalg.norm(ref)), 1e-300)))


def compare(args):
    ref = np.load(args.ref)
    keys = sorted({k.rsplit("_", 1)[0] for k in ref.files if k[0] == "m"
                   and k.endswith("_u")})
    for path in args.runs:
        got = np.load(path)
        print(f"== {got['variant']} (M* tol {float(got['mstar_tol']):g}) "
              f"against {ref['variant']} (M* tol "
              f"{float(ref['mstar_tol']):g})")
        for key in keys:
            if f"{key}_u" not in got.files:
                continue
            parts = []
            for q in ("b", "Ab", "x", "u"):
                mx, nrm = _d(ref[f"{key}_{q}"], got[f"{key}_{q}"])
                parts.append(f"{q} {mx:.2e}/{nrm:.2e}")
            e0, e1 = ref[f"{key}_errors"], got[f"{key}_errors"]
            n = min(len(e0), len(e1))
            apart = np.abs(e1[:n] - e0[:n]) > 1e-6 * np.abs(e0[:n])
            first = int(np.argmax(apart)) if apart.any() else None
            c0, c1 = ref[f"{key}_counts"], got[f"{key}_counts"]
            print(f"  {key}: " + ", ".join(parts)
                  + f"; counts {list(c1)} (ref {list(c0)}); CG histories "
                  f"part at iteration {first}; errors at 1..4 "
                  + " ".join(f"{v:.9e}" for v in e1[1:5])
                  + " (ref " + " ".join(f"{v:.9e}" for v in e0[1:5]) + ")")
            if key.endswith("s0") or key.endswith("s1"):
                u, ub = got[f"{key}_u"], got["u_bc"]
                print(f"    max |u| {np.abs(u).max():.10f} (ref "
                      f"{np.abs(ref[f'{key}_u']).max():.10f}), ||u - u_bc|| "
                      f"{np.linalg.norm(u - ub):.9e} (ref "
                      f"{np.linalg.norm(ref[f'{key}_u'] - ub):.9e})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--variant", choices=VARIANTS, required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--members", default="0,1,7",
                   type=lambda s: [int(x) for x in s.split(",")])
    r.add_argument("--steps", type=int, default=2)
    r.add_argument("--mstar-tol", type=float, default=1e-4)
    r.add_argument("--jax-bases", action="store_true")
    t = sub.add_parser("terms")
    t.add_argument("--variant", choices=VARIANTS, required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--jax-bases", action="store_true")
    for name in ("compare", "compare-terms", "jax"):
        c = sub.add_parser(name)
        c.add_argument("ref")
        c.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    {"run": run, "compare": compare, "terms": terms,
     "compare-terms": compare_terms, "jax": against_jax}[args.cmd](args)


if __name__ == "__main__":
    main()

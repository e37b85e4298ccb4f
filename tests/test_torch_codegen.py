"""The generated C++ of the function DSL (mrhyde_tpu_torch/functions/
codegen.py) and the dual numbers and weak forms it runs on
(ops/csrc/dual.cuh, ns_density.cuh, scalar_density.cuh), compiled on the
host: with `__device__` and `__forceinline__` defined empty, the headers
are plain C++, which g++ builds into a small shared library. Each
expression's value and tangent are held to the port's torch evaluation
and torch.func.jvp at seeded points (f64, 1e-14 relative), and at the
kinks (abs at 0, min / max at a tie, sqrt at 0, pow with base 0) to the
JAX package's sparse forward AD, whose conventions the kernel follows.
Each module set's generated density (the body of the set_node_full
kernel) is held to the plain version's density, value and tangent, at
seeded states. The tests skip where there is no host C++ compiler."""

import ctypes
import math
import os
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import cdr_cfg, channel_cfg, thermal_cfg  # noqa: E402

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mrhyde_tpu_torch", "ops", "csrc")
PRELUDE = """
#include <math.h>
#define __device__
#define __host__
#define __forceinline__ inline
#include "dual.cuh"
#include "ns_density.cuh"
#include "scalar_density.cuh"
namespace {
struct SetArgs {
  double h, tau_dt2;
  double sc[32];
  int pspg, supg;
};
}  // namespace
"""
# the variables of the expression tests, the parameter kp (sc[3]) and
# the named function f1
VARS = ("c", "e")
PARAMS = ("kp",)
EXPRS = (
    "1.5*c + 2", "c - e", "-c", "c/e", "2 - c", "3/c", "c*e*x", "e^2",
    "c^e", "2^c", "e^0.5", "pow(c, 3)", "pow(2, e)", "sin(c)", "cos(c)",
    "tan(c)", "exp(c)", "log(c)", "sqrt(c)", "abs(c - 1)", "sinh(c)",
    "cosh(c)", "tanh(c)", "min(c, e)", "max(c, e)", "min(c, 0.9)",
    "max(2, e)", "atan2(c, e)", "atan2(c, 2)", "mean(c, e)", "(c < e)*e",
    "(c > e) + c", "x*y + t", "sin(2*pi*x)*c + 2*pi", "kp*c", "f1 + 1",
    "1.0 + e*c", "0.1*c^2", "1.0 + 0.1*c*c", "exp(-(x-0.5)^2/0.1)*c",
)
# expression, state (c, e), column tangent (tc, te): points where the
# rules choose (the JAX package's sparse AD decides)
KINKS = (
    ("abs(c)", (0.0, 0.3), (1.0, 0.0)),
    ("max(c, e)", (0.4, 0.4), (1.0, 0.0)),
    ("max(c, e)", (0.4, 0.4), (0.0, 1.0)),
    ("min(c, e)", (0.4, 0.4), (0.0, 1.0)),
    ("min(c, e)", (0.4, 0.4), (1.0, 0.0)),
    ("sqrt(c) + e", (0.0, 0.3), (0.0, 1.0)),
    ("sqrt(c) + e", (0.0, 0.3), (1.0, 0.0)),
    ("c^2 + e", (0.0, 0.3), (1.0, 0.0)),
    ("c^e", (0.0, 0.3), (1.0, 0.0)),
    ("c^e", (0.0, 0.3), (0.0, 1.0)),
    ("c^0.5*e", (0.0, 0.3), (0.0, 1.0)),
    ("log(c)*e", (0.0, 0.3), (0.0, 1.0)),
)


def _fm():
    from mrhyde_tpu_torch.functions.manager import FunctionManager
    fm = FunctionManager()
    fm.add_function("f1", "c*c")
    return fm


def _expr_code(text, fm):
    from mrhyde_tpu_torch.functions import codegen
    from mrhyde_tpu_torch.functions.parser import parse_expression
    expr = codegen.inline(parse_expression(text), fm)
    return codegen.expr_code(expr, codegen.leaf_coder(VARS, PARAMS))


def _expr_source(exprs, fm):
    body = [PRELUDE]
    for i, text in enumerate(exprs):
        code = _expr_code(text, fm)
        body.append(f"""
extern "C" void expr{i}(const double* st, const double* tg,
                        const double* env, double* out) {{
  using T = double;
  SetArgs a;
  a.sc[3] = env[3];
  const T x = env[0], y = env[1], t = env[2];
  (void)x; (void)y; (void)t; (void)a;
  {{
    using S = Dual<double, 1>;
    S u[2];
    for (int k = 0; k < 2; ++k) {{ u[k].v = st[k]; u[k].d[0] = tg[k]; }}
    const S r = lift<S>({code});
    out[0] = r.v;
    out[1] = r.d[0];
  }}
  {{
    const T u[2] = {{st[0], st[1]}};
    out[2] = {code};
  }}
}}""")
    return "\n".join(body)


def _compile(source, tmp, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the generated "
                    "code on the CPU")
    src = tmp / f"{name}.cpp"
    lib = tmp / f"lib{name}.so"
    src.write_text(source)
    out = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                          "-Wno-unknown-pragmas", "-I", CSRC, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def expr_lib(tmp_path_factory):
    fm = _fm()
    lib = _compile(_expr_source(EXPRS + tuple(k[0] for k in KINKS), fm),
                   tmp_path_factory.mktemp("codegen"), "exprs")
    return lib, fm


def _call(lib, i, st, tg, env):
    dbl = ctypes.POINTER(ctypes.c_double)
    out = np.zeros(3)
    arrs = [np.ascontiguousarray(a, dtype=np.float64)
            for a in (st, tg, env)]
    getattr(lib, f"expr{i}")(*(a.ctypes.data_as(dbl) for a in arrs),
                             out.ctypes.data_as(dbl))
    return out


class _Ctx:
    def __init__(self, vals, env):
        self.vals, self.env = vals, env

    def resolve(self, leaf):
        if leaf in self.vals:
            return self.vals[leaf]
        return {"x": self.env[0], "y": self.env[1], "t": self.env[2],
                "kp": self.env[3]}[leaf]


def _torch_ref(fm, text, st, tg, env):
    """(value, tangent) of the port's torch evaluation, through
    torch.func.jvp."""
    def f(c, e):
        return torch.as_tensor(fm.evaluate_expr(text, _Ctx(
            {"c": c, "e": e}, env)), dtype=torch.float64)
    val, tan = torch.func.jvp(
        f, tuple(torch.tensor(v, dtype=torch.float64) for v in st),
        tuple(torch.tensor(v, dtype=torch.float64) for v in tg))
    return float(val), float(tan)


@pytest.mark.parametrize("i", range(len(EXPRS)), ids=EXPRS)
def test_expression_value_and_tangent(expr_lib, i):
    lib, fm = expr_lib
    rng = np.random.RandomState(100 + i)
    for _ in range(4):
        st = rng.uniform(0.5, 1.5, 2)
        tg = rng.uniform(-1.0, 1.0, 2)
        env = np.array([rng.uniform(0, 1), rng.uniform(0, 1), 0.3, 1.7])
        val, tan, primal = _call(lib, i, st, tg, env)
        rv, rt = _torch_ref(fm, EXPRS[i], st, tg, env)
        assert abs(val - rv) <= 1e-14 * max(1.0, abs(rv))
        assert primal == val
        assert abs(tan - rt) <= 1e-14 * max(1.0, abs(rt)), (tan, rt)


def _jax_column(text, st, tg):
    """The JAX kernel's column derivative: its sparse forward AD over the
    slots (c, e), each slot's derivative times its tangent, structural
    zeros and zero tangents left out (the kernel's column seeds one
    slot). The slots are seeded with arrays of ones: `sparse_jacfwd`'s
    scalar seeds meet its select rule (max, min) with a shape error."""
    import jax.numpy as jnp
    from mrhyde_tpu.functions.parser import parse_expression as jparse
    from mrhyde_tpu.ops.sparse_fwd import _eval_sparse
    expr = jparse(text)

    def f(z):
        vals = {"c": z[0], "e": z[1]}
        return [expr.evaluate(lambda leaf: vals[leaf])]
    z0 = [jnp.asarray([v]) for v in st]
    closed = jax.make_jaxpr(f)(z0)
    ((out0, tdict),) = _eval_sparse(closed.jaxpr, closed.consts, z0,
                                    [{k: jnp.ones_like(z0[k])}
                                     for k in range(2)])
    tan = 0.0
    for k, d in tdict.items():
        if tg[k] != 0.0:
            tan = tan + float(np.asarray(d).reshape(-1)[0]) * tg[k]
    return float(np.asarray(out0).reshape(-1)[0]), tan


@pytest.mark.parametrize("k", range(len(KINKS)),
                         ids=[f"{t}@{s}d{d}" for t, s, d in KINKS])
def test_kink_conventions_follow_jax(expr_lib, k):
    lib, fm = expr_lib
    text, st, tg = KINKS[k]
    val, tan, _ = _call(lib, len(EXPRS) + k, st, tg,
                        np.array([0.2, 0.4, 0.3, 1.7]))
    jv, jt = _jax_column(text, st, tg)
    assert val == jv
    # the same number, the same infinity or both NaN (0 log 0)
    assert np.array_equal([tan], [jt], equal_nan=True), (tan, jt)


DRSQRT_TU = """
#include "cuda_runtime.h"
#include "dual.cuh"
extern "C" void drsqrt2(double x, double t0, double t1, double* out) {
  Dual<double, 2> a;
  a.v = x;
  a.d[0] = t0;
  a.d[1] = t1;
  const Dual<double, 2> r = drsqrt(a);
  out[0] = r.v;
  out[1] = r.d[0];
  out[2] = r.d[1];
  out[3] = drsqrt(x);
}
"""


def test_dual_rsqrt_follows_jax(tmp_path):
    """dual.cuh's drsqrt (ns_node_full's tau) against the JAX package's
    sparse forward AD of lax.rsqrt, column by column: the value and each
    tangent times the derivative -r / (2 x), a zero tangent left out, so
    at x = 0 the infinite derivative reaches only a column that moves x,
    as -inf, and the others stay 0."""
    import jax.numpy as jnp
    from jax import lax
    from mrhyde_tpu.ops.sparse_fwd import _eval_sparse
    lib = _host_build(DRSQRT_TU, tmp_path)
    lib.drsqrt2.argtypes = [ctypes.c_double] * 3 + [ctypes.c_void_p]
    closed = jax.make_jaxpr(lambda z: [lax.rsqrt(z[0])])([jnp.ones(1)])
    for x, tg in ((4.0, (1.0, 0.0)), (2.5, (0.5, -2.0)), (0.0, (1.0, 0.0)),
                  (0.0, (0.0, -3.0))):
        out = np.zeros(4)
        lib.drsqrt2(x, *tg, out.ctypes.data)
        ((jv, tdict),) = _eval_sparse(closed.jaxpr, closed.consts,
                                      [jnp.asarray([x])],
                                      [{0: jnp.ones(1)}])
        d = float(np.asarray(tdict[0]).reshape(-1)[0])
        want = [float(np.asarray(jv).reshape(-1)[0])] + \
            [d * t if t != 0.0 else 0.0 for t in tg]
        assert out[0] == out[3]
        for got, ref in zip(out[:3], want):
            assert got == ref or abs(got - ref) <= 1e-15 * abs(ref), \
                (x, tg, out, want)


def test_unsupported_leaves_raise():
    from mrhyde_tpu_torch.functions import codegen
    from mrhyde_tpu_torch.functions.parser import parse_expression
    code = codegen.leaf_coder(VARS, PARAMS)
    for text in ("grad(c)[x]", "c_t", "z", "emax(c)", "kp(1)", "q"):
        with pytest.raises(codegen.Unsupported):
            codegen.expr_code(parse_expression(text), code)
    assert codegen.expr_code(parse_expression("2*pi*0.5"), code) == \
        "T(3.1415926535897931)"


# ----------------------------------------------------------------------
# the generated densities of module sets
# ----------------------------------------------------------------------

def _set_cfgs():
    """name -> deck of each module-set case of the provider tests."""
    ns_thermal = channel_cfg(4, 4, supg=True, box=(1.0, 1.0))
    ns_thermal["Physics"].update({"modules": "navier stokes,thermal",
                                  "beta": 2.5, "T_ambient": 0.25,
                                  "include advection": True})
    ns_thermal["Functions"].update({"source uy": "-1.0 + 0.5*x",
                                    "advection x": "ux",
                                    "advection y": "uy",
                                    "thermal diffusion": "1.0 + 0.1*e*e"})
    ns_cdr = channel_cfg(4, 4, supg=True)
    ns_cdr["Physics"]["modules"] = "navier stokes,cdr"
    ns_cdr["Functions"].update({"source ux": "1.0 + 0.1*c^2", "xvel": "ux",
                                "yvel": "uy", "diffusion": "0.01",
                                "reaction": "0.5*c*c"})
    thermal_cdr = thermal_cfg(4)
    thermal_cdr["Physics"]["modules"] = "thermal,cdr"
    thermal_cdr["Functions"].update({"thermal diffusion": "1 + e*c",
                                     "xvel": "2.0", "yvel": "1.0"})
    cdr_state = cdr_cfg(4)
    cdr_state["Functions"]["xvel"] = "c"
    visc = channel_cfg(4, 4)
    visc["Functions"]["viscosity"] = "1.0 + ux*ux"
    return {"ns_thermal": ns_thermal, "ns_cdr": ns_cdr,
            "thermal_cdr": thermal_cdr, "cdr_state": cdr_state,
            "ns_visc": visc}


def _density_source(form):
    from mrhyde_tpu_torch.functions import codegen
    nv, dim = len(form.variables), form.dim
    nq = (2 + dim) * nv
    no = (1 + dim) * nv
    xyz = ", ".join(f"xy[{dim} * i + {d}]" for d in range(dim))
    return PRELUDE + "namespace {\n" + codegen.density_struct(
        form.modules, form.variables, form.params, form.fm, dim) + f"""
}}  // namespace
extern "C" void density(int n, const double* st, const double* tg,
                        const double* xy, const double* sc, double h,
                        double tau_dt2, int pspg, int supg, int tr,
                        double* out) {{
  using D = Dual<double, 1>;
  SetArgs a;
  a.h = h;
  a.tau_dt2 = tau_dt2;
  a.pspg = pspg;
  a.supg = supg;
  for (int k = 0; k < 32; ++k) a.sc[k] = sc[k];
  for (int i = 0; i < n; ++i) {{
    const double* s = st + i * {nq};
    const double* d = tg + i * {nq};
    D u[{nv}], ud[{nv}], g[{nv}][{dim}], o[{no}];
    for (int v = 0; v < {nv}; ++v) {{
      u[v].v = s[v]; u[v].d[0] = d[v];
      ud[v].v = s[{nv} + v]; ud[v].d[0] = d[{nv} + v];
      for (int k = 0; k < {dim}; ++k) {{
        g[v][k].v = s[{2 * nv} + {dim} * v + k];
        g[v][k].d[0] = d[{2 * nv} + {dim} * v + k];
      }}
    }}
    if (tr) GenDensity::eval<true, D>(u, ud, g, {xyz}, a, o);
    else GenDensity::eval<false, D>(u, ud, g, {xyz}, a, o);
    for (int k = 0; k < {no}; ++k) {{
      out[i * {2 * no} + k] = o[k].v;
      out[i * {2 * no} + {no} + k] = o[k].d[0];
    }}
  }}
}}
"""


def _check_density(cfg, transient, tmp_path):
    """The deck's generated density against the plain version's summed
    module densities with torch.func.jvp, at seeded states, coordinates
    and tangents (f64, 1e-13 of the largest value and tangent)."""
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly, \
        SetScalars, _density
    from mrhyde_tpu_torch.problem import Problem
    if transient:
        cfg["Solver"] = {"solver": "transient", "final time": 0.04,
                         "number of steps": 4}
    fused = Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    assert isinstance(fused, FusedSetAssembly)
    form = fused.form
    lib = _compile(_density_source(form), tmp_path, "density")
    nv, dim = len(form.variables), form.dim
    nq = (2 + dim) * nv
    n = 7
    rng = np.random.RandomState(7)
    st = rng.uniform(-1.0, 1.0, (n, nq))
    tg = rng.uniform(-1.0, 1.0, (n, nq))
    if not transient:
        st[:, nv:2 * nv] = 0.0
        tg[:, nv:2 * nv] = 0.0
    xy = rng.uniform(0.0, 1.0, (n, dim))
    sc = SetScalars(0.3, 0.01, ())
    scal = np.zeros(32)
    scal[:3 + len(form.params)] = form.scalars(sc)
    ns = form.ns
    no = (1 + dim) * nv
    out = np.zeros((n, 2 * no))
    dbl = ctypes.POINTER(ctypes.c_double)
    lib.density(ctypes.c_int(n), *(np.ascontiguousarray(a).ctypes.data_as(
        dbl) for a in (st, tg, xy, scal)), ctypes.c_double(form.h),
        ctypes.c_double(form.tau_dt2(sc.deltat)),
        ctypes.c_int(int(bool(ns and ns.use_pspg))),
        ctypes.c_int(int(bool(ns and ns.use_supg))),
        ctypes.c_int(int(transient)), out.ctypes.data_as(dbl))
    xt = torch.as_tensor(xy)
    dens = _density(form, lambda _q: [xt[:, d] for d in range(dim)], sc)

    def f(z):
        u = [z[:, v] for v in range(nv)]
        ud = [z[:, nv + v] for v in range(nv)] if transient \
            else [0.0] * nv
        g = [[z[:, 2 * nv + dim * v + d] for d in range(dim)]
             for v in range(nv)]
        return torch.stack([torch.broadcast_to(torch.as_tensor(
            o, dtype=torch.float64), (n,)) for o in dens(0, u, ud, g)],
            dim=1)
    val, tan = torch.func.jvp(f, (torch.as_tensor(st),),
                              (torch.as_tensor(tg),))
    scale = 1.0 + float(val.abs().max())
    assert np.max(np.abs(out[:, :no] - val.numpy())) <= 1e-13 * scale
    tscale = 1.0 + float(tan.abs().max())
    assert np.max(np.abs(out[:, no:] - tan.numpy())) <= 1e-13 * tscale
    return form


@pytest.mark.parametrize("name", ["ns_thermal", "ns_cdr", "thermal_cdr",
                                  "cdr_state", "ns_visc"])
@pytest.mark.parametrize("transient", [False, True])
def test_generated_density_matches_plain(name, transient, tmp_path):
    """The generated density (a column's Dual<T, 1> pass of the kernel)
    against the plain version's summed module densities with
    torch.func.jvp, at seeded states, coordinates and tangents."""
    form = _check_density(_set_cfgs()[name], transient, tmp_path)
    assert (form.dim, form.nc) == (2, 4)


def _elem_set_cfgs():
    """name -> deck of a module set on hex or p2: NS + thermal whose
    diffusion reads z and whose velocity is the flow's three components,
    NS + thermal + cdr (nd = 48),
    NS + cdr advected by (ux, uy, uz), thermal + cdr, cdr advected by (c,
    1, z), NS with viscosity 1 + ux^2, and NS + thermal on p2."""
    from torch_port_utils import (ns_cdr_elem_cfg, ns_elem_cfg,
                                  ns_thermal_cdr_elem_cfg,
                                  ns_thermal_elem_cfg)
    ns_thermal = ns_thermal_elem_cfg("hex", (2, 2, 2), supg=True,
                                     kappa="1.0 + 0.1*e*e + 0.2*z")
    thermal_cdr = cdr_cfg(2, 2, 2, reaction="0.5*c*c")
    thermal_cdr["Physics"]["modules"] = "thermal,cdr"
    thermal_cdr["Functions"].update({"thermal diffusion": "1 + e*c*z",
                                     "xvel": "2.0", "zvel": "e"})
    cdr_state = cdr_cfg(2, 2, 2)
    cdr_state["Functions"].update({"xvel": "c", "yvel": "1.0",
                                   "zvel": "z"})
    return {"ns_thermal_hex": ns_thermal,
            "ns_thermal_cdr_hex": ns_thermal_cdr_elem_cfg("hex", (2, 2, 2)),
            "ns_cdr_hex": ns_cdr_elem_cfg("hex", (2, 2, 2)),
            "thermal_cdr_hex": thermal_cdr, "cdr_state_hex": cdr_state,
            "ns_visc_hex": ns_elem_cfg("hex", (2, 2, 2),
                                       visc="1.0 + ux*ux"),
            "ns_thermal_p2": ns_thermal_elem_cfg("p2", (2, 2), supg=True)}


@pytest.mark.parametrize("name", ["ns_thermal_hex", "ns_thermal_cdr_hex",
                                  "ns_cdr_hex", "thermal_cdr_hex",
                                  "cdr_state_hex", "ns_visc_hex",
                                  "ns_thermal_p2"])
@pytest.mark.parametrize("transient", [False, True])
def test_generated_elem_density_matches_plain(name, transient, tmp_path):
    """The density of set_elem_full's generated source (DIM = 3 on hex,
    with scalar_density.cuh's 3D velocity and the coordinate z; DIM = 2
    on p2) against the plain version and torch.func.jvp, as above."""
    form = _check_density(_elem_set_cfgs()[name], transient, tmp_path)
    assert (form.dim, form.nc) == ((2, 9) if name.endswith("p2")
                                   else (3, 8))
    assert '#include "set_elem.cuh"' in form.source
    assert "SET_ELEM_ENTRY_POINTS(GenDensity)" in form.source


def test_z_is_a_kernel_argument_in_3d_only():
    from mrhyde_tpu_torch.functions import codegen
    from mrhyde_tpu_torch.functions.parser import parse_expression
    expr = parse_expression("x + y*z")
    assert codegen.expr_code(expr, codegen.leaf_coder(VARS, PARAMS, 3)) \
        == "(x + (y * z))"
    with pytest.raises(codegen.Unsupported):
        codegen.expr_code(expr, codegen.leaf_coder(VARS, PARAMS, 2))


@pytest.mark.parametrize("mesh", ["p1", "p2", "hex"])
def test_2d_and_3d_sources_call_their_own_scalar_densities(mesh):
    """A 2D source (p1 or p2 quads) calls the 2D thermal and cdr
    densities with the velocity (b0, b1), a hex source the 3D ones with
    (b0, b1, b2): scalar_density.cuh keeps the two apart, so that
    set_node_full's 2D kernels keep their bits."""
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    from mrhyde_tpu_torch.problem import Problem
    from torch_port_utils import ns_thermal_elem_cfg
    if mesh == "p1":
        cfg = ns_thermal_elem_cfg("p2", (2, 2))
        cfg["Discretization"] = {"order": {v: 1 for v in (
            "ux", "uy", "pr", "e")}, "quadrature": 2}
    else:
        cfg = ns_thermal_elem_cfg(mesh, (2, 2, 2) if mesh == "hex"
                                  else (2, 2))
    cfg["Physics"]["modules"] = "navier stokes,thermal,cdr"
    cfg["Physics"]["Dirichlet conditions"]["c"] = {"left": 1.0}
    cfg["Physics"]["Initial conditions"]["c"] = 0.0
    cfg["Discretization"]["order"]["c"] = cfg["Discretization"][
        "order"]["e"]
    cfg["Functions"].update({"xvel": "ux", "yvel": "uy", "zvel": "uz",
                             "diffusion": "0.01", "reaction": "0.0"})
    if mesh != "hex":
        del cfg["Functions"]["zvel"]
    cfg["Postprocess"]["True solutions"]["c"] = "0.0"
    fused = Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    assert isinstance(fused, FusedSetAssembly)
    import re
    src = fused.form.source
    fn, nb = ("_3d", 3) if mesh == "hex" else ("", 2)
    # the arguments before the output: the state (u, u_dot, g), the
    # module's coefficients and the velocity's nb components
    assert re.search(rf"thermal_density{fn}<true, S>\((?:\w+(?:\[\d\])?, )"
                     rf"{{{7 + nb}}}m\d\);", src)
    assert re.search(rf"cdr_density{fn}<S>\((?:\w+(?:\[\d\])?, )"
                     rf"{{{8 + nb}}}m\d\);", src)
    assert ("_3d" in src) == (mesh == "hex")


# ----------------------------------------------------------------------
# set_node.cuh's kernel templates, the element-tile engine
# (elem_engine.cuh, instanced by set_elem.cuh, set_node.cuh and
# fused_elem_ns.cu) and fused_elem_thermal.cu's kernels run on the host:
# one std::thread per CUDA thread of a block, a barrier for __syncthreads,
# for __syncwarp and around a warp shuffle (every thread of the block
# shuffles and syncs its warp at the same points), the block's shared memory a host buffer (filled with NaN
# bytes, so a read of a slot no thread wrote shows); the launches and the
# shared-memory declarations are the lines rewritten for the host, the
# card's opt-in shared memory per block is HOST_OPTIN (the H100's unless
# a test sets a smaller one, to make the kernels hold fewer elements per
# block) and its SMs HOST_SMS (2: a persistent grid walks several tiles
# per block). The host build has no __CUDA_ARCH__, so f64's tensor-core
# steps take their FMA form.
# ----------------------------------------------------------------------

HOST_CUDA = """
#pragma once
#include <math.h>
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>
#ifndef HOST_OPTIN
#define HOST_OPTIN 232448
#endif
#ifndef HOST_SMS
#define HOST_SMS 2
#endif
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
struct HostIdx { unsigned x; };
inline thread_local HostIdx threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* host_barrier = nullptr;
inline unsigned char* host_smem = nullptr;
inline double* host_xchg = nullptr;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
template <class T> T __shfl_sync(unsigned, T v, int src) {
  host_xchg[threadIdx.x] = (double)v;
  __syncthreads();
  const T r = (T)host_xchg[(threadIdx.x & ~31u) + (unsigned)src];
  __syncthreads();
  return r;
}
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin,
                      cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? HOST_SMS : HOST_OPTIN;
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
// one block per SM: the kernels then take the most elements that fit
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }
template <class K, class... A>
void host_launch(K kernel, unsigned blocks, int threads, size_t smem,
                 A... args) {
  std::vector<unsigned char> buf(smem + 1);
  std::vector<double> xchg(threads);
  host_xchg = xchg.data();
  for (unsigned b = 0; b < blocks; ++b) {
    std::memset(buf.data(), 0xff, smem);
    host_smem = buf.data();
    std::barrier<> bar(threads);
    host_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=]() {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = threads;
        gridDim.x = blocks;
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
"""
HOST_SMEM = (re.compile(r"extern __shared__ (?:__align__\(16\) )?"
                        r"unsigned char smem_raw\[\];"),
             "unsigned char* smem_raw = host_smem;")
HOST_LAUNCH = re.compile(r"kernel<<<(.*?), ((?:\w+::)?kThreads), (.*?),\s*"
                         r"\(cudaStream_t\)stream>>>\((.*?)\);", re.S)


# the kernel files the host builds, each with its counts of shared-memory
# declarations and of launch sites: the element-tile engine holds the
# kernel body of set_elem_full and ns_elem_full (set_elem.cuh and
# fused_elem_ns.cu instantiate it) and of set_node.cuh's Jacobian role;
# set_elem.cuh holds set_elem_state's kernel, set_node.cuh
# set_node_state's and set_node_full's; fused_elem_thermal.cu's one tile
# kernel holds both thermal element modes; the B2 node kernels
# (fused_p1_thermal.cu: thermal_node_state's and thermal_node_full's tile
# walk; fused_p1_ns.cu: ns_node_full's tiles); node_walk.cuh the tile walk
# that fused_p1_thermal.cu and set_node.cuh include; launch.cuh the
# launchers' shared-memory error and persistent grid size; thermal_form.cuh
# the thermal weak form's qp scalars and products that both thermal files
# include
HOST_FILES = {"set_node.cuh": (2, 2), "elem_engine.cuh": (1, 1),
              "set_elem.cuh": (1, 1), "fused_elem_ns.cu": (0, 0),
              "fused_elem_thermal.cu": (1, 1),
              "fused_p1_thermal.cu": (2, 2), "fused_p1_ns.cu": (1, 1),
              "node_walk.cuh": (0, 0), "launch.cuh": (0, 0),
              "thermal_form.cuh": (0, 0)}


def _host_header(name, tmp_path):
    """csrc/<name> rewritten for the host into tmp_path."""
    text = open(os.path.join(CSRC, name)).read()
    smem, launches = HOST_FILES[name]
    text, n = HOST_SMEM[0].subn(HOST_SMEM[1], text)
    assert n == smem, name
    text, n = HOST_LAUNCH.subn(
        r"host_launch(kernel, \1, \2, \3, \4);", text)
    assert n == launches, name
    (tmp_path / name).write_text(text)


def _host_build(source, tmp_path, optin=None):
    """A translation unit that includes the kernel headers, built for the
    host into a shared library (HOST_OPTIN = optin where given)."""
    for name in HOST_FILES:
        _host_header(name, tmp_path)
    (tmp_path / "cuda_runtime.h").write_text(HOST_CUDA)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel on the "
                    "CPU")
    src, lib = tmp_path / "gen.cpp", tmp_path / "libgen.so"
    src.write_text(source)
    flags = [] if optin is None else [f"-DHOST_OPTIN={optin}"]
    out = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                          "-pthread", "-Wno-unknown-pragmas", *flags, "-I",
                          str(tmp_path), "-I", CSRC, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if out.returncode != 0 and "barrier" in out.stderr:
        pytest.skip("the host C++ library has no std::barrier (C++20)")
    assert out.returncode == 0, out.stderr[-4000:]
    return ctypes.CDLL(str(lib))


def _entry(lib, name, dtype):
    fn = getattr(lib, f"{name}_f64" if dtype == torch.float64
                 else f"{name}_f32")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _assert_close(got, want, dtype):
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((got - want).abs().max()) <= \
        rtol * float(want.abs().max())


@pytest.mark.parametrize("name", ["ns_thermal_hex", "ns_cdr_hex",
                                  "ns_thermal_cdr_hex", "ns_thermal_p2"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_set_elem_kernel_template_on_the_host(name, dtype, tmp_path):
    """set_elem_full's kernel (its tables, corner gathers, qp state,
    residual rows and column passes through shared memory) against its
    plain version on seeded grids of several blocks, the last one
    partial: f64 to 1e-12, f32 to 1e-5 of max |plain|."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables, Stage
    from mrhyde_tpu_torch.problem import Problem
    cfg = _elem_set_cfgs()[name]
    cfg["Mesh"].update({"NX": 5, "NY": 3, "NZ": 2} if name.endswith("hex")
                       else {"NX": 7, "NY": 5})
    cfg["Solver"] = {"solver": "transient", "final time": 0.04,
                     "number of steps": 4}
    f = Problem(cfg, device="cpu", dtype=torch.float64).assembler \
        .fused_provider()
    stage = name != "ns_thermal_hex"
    au, at = (0.5, 200.0) if stage else (1.0, 0.0)
    sc = fs.SetScalars(0.0125, 0.01, ())
    jac_idx = f._classify(sc, au, at, not stage)[0]
    rng = np.random.RandomState(17)
    shape = (f.nv,) + tuple(f.grid_shape)
    ue = torch.as_tensor(rng.rand(*shape) - 0.5, dtype=dtype)
    ud = torch.as_tensor(20 * (rng.rand(*shape) - 0.5), dtype=dtype) \
        if stage else None
    t = f.tables
    tab = QuadTables(t.phi, t.grad, t.wts, "cpu", dtype)
    args = (f.form, ue, ud, sc, tab, f.lattice,
            (f.origin, f.h_axes, f.q_off), jac_idx,
            Stage(au, at, None) if stage else None)
    ref = fs.set_elem_full_plain(*args)
    a, res, jac, _keep = fs._elem_args(*args)
    lib = _host_build(f.form.source, tmp_path)
    assert _entry(lib, "set_elem_full", dtype)(ctypes.addressof(a),
                                                None) == 0
    for got, want in zip((res, jac), ref):
        _assert_close(got, want, dtype)


def _host_provider(cfg, quadrature=None, transient=False):
    from mrhyde_tpu_torch.problem import Problem
    if quadrature is not None:
        cfg["Discretization"]["quadrature"] = quadrature
    if transient:
        cfg["Solver"] = {"solver": "transient", "final time": 0.04,
                         "number of steps": 4}
    return Problem(cfg, device="cpu", dtype=torch.float64).assembler \
        .fused_provider()


def _host_grids(f, dtype, stage, seed=17):
    rng = np.random.RandomState(seed)
    shape = (f.nv,) + tuple(f.grid_shape)
    ue = torch.as_tensor(rng.rand(*shape) - 0.5, dtype=dtype)
    ud = torch.as_tensor(20 * (rng.rand(*shape) - 0.5), dtype=dtype) \
        if stage else None
    return ue, ud


def _host_tables(f, dtype):
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    t = f.tables
    return QuadTables(t.phi, t.grad, t.wts, "cpu", dtype)


@pytest.mark.parametrize("name", ["ns_thermal", "ns_cdr", "thermal_cdr",
                                  "cdr_state", "ns_visc"])
@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_set_node_kernel_on_the_host(name, stage, dtype, tmp_path):
    """set_node_full (its residual role, node-scattered, and its Jacobian
    role on the element-tile engine at nc = 4: one linearization per
    (element, qp) contracted with the basis tables) on the host against
    its plain version at Q = 4: each module set of the provider tests on
    a 7x5 grid (several Jacobian blocks, the last one partial), steady
    and at a DIRK-2,2 stage; f64 to 1e-12, f32 to 1e-5 of max |plain|."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    cfg = _set_cfgs()[name]
    cfg["Mesh"].update({"NX": 7, "NY": 5})
    f = _host_provider(cfg, transient=stage)
    assert isinstance(f, fs.FusedSetAssembly) and f.tables.Q == 4
    au, at = (0.5, 200.0) if stage else (1.0, 0.0)
    sc = fs.SetScalars(0.0125, 0.01, ())
    jac_idx = f._classify(sc, au, at, not stage)[0]
    ue, ud = _host_grids(f, dtype, stage)
    args = (f.form, ue, ud, sc, _host_tables(f, dtype),
            (f.origin, f.h_axes, f.q_off), jac_idx,
            Stage(au, at, None) if stage else None)
    ref = fs.set_node_full_plain(*args)
    a, out, jac, _keep = fs._node_args(*args, False)
    lib = _host_build(f.form.source, tmp_path)
    assert _entry(lib, "set_node_full", dtype)(ctypes.addressof(a),
                                                None) == 0
    for got, want in zip((out, jac), ref):
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_set_node_kernel_at_quadrature_8_in_blocks_of_fewer_elements(
        dtype, tmp_path):
    """set_node_full at Q = 25 (2D p1, quadrature 8), where a set_node
    Jacobian block held 16 qps at most before: the NS channel with
    viscosity 1 + 0.1 ux^2 (a state-reading coefficient) on the host,
    with a card whose shared memory holds 4 elements per block (8 in
    f32), against its plain version: f64 to 1e-12, f32 to 1e-5 of max
    |plain|."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops._launch import block_elems, node_smem_words
    from torch_port_utils import channel_cfg
    f = _host_provider(channel_cfg(7, 5, visc="1.0 + 0.1*ux*ux"), 8)
    assert isinstance(f, fs.FusedSetAssembly) and f.tables.Q == 25
    optin = 12000
    words = lambda el: node_smem_words(3, False, 25, el)  # noqa: E731
    assert block_elems(words, dtype.itemsize, optin) == \
        (4 if dtype == torch.float64 else 8)
    sc = fs.SetScalars(0.0, 1.0, ())
    jac_idx = f._classify(sc, 1.0, 0.0, True)[0]
    ue, _ = _host_grids(f, dtype, False)
    args = (f.form, ue, None, sc, _host_tables(f, dtype),
            (f.origin, f.h_axes, f.q_off), jac_idx, None)
    ref = fs.set_node_full_plain(*args)
    a, out, jac, _keep = fs._node_args(*args, False)
    lib = _host_build(f.form.source, tmp_path, optin)
    assert _entry(lib, "set_node_full", dtype)(ctypes.addressof(a),
                                                None) == 0
    for got, want in zip((out, jac), ref):
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("stage", [False, True])
def test_set_elem_kernel_at_quadrature_6_in_blocks_of_fewer_elements(
        stage, tmp_path):
    """set_elem_full at Q = 64 (hex, quadrature 6), past the 27 qps its
    layout held before: NS + thermal on the hex channel, steady and at a
    DIRK-2,2 stage, on the host with the H100's shared memory (a layout of
    4 elements per block fits in f64; the qps take 13 linearization
    chunks), against its plain version to 1e-12."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops._launch import (SMEM_OPTIN, block_elems,
                                              elem_smem_words)
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from torch_port_utils import ns_thermal_elem_cfg
    cfg = ns_thermal_elem_cfg("hex", (3, 2, 2), supg=stage)
    f = _host_provider(cfg, 6, stage)
    assert isinstance(f, fs.FusedSetAssembly) and f.tables.Q == 64
    assert block_elems(lambda el: elem_smem_words(3, 8, 5, stage, 64, el),
                       8, SMEM_OPTIN) == 4
    dtype = torch.float64
    au, at = (0.5, 200.0) if stage else (1.0, 0.0)
    sc = fs.SetScalars(0.0125, 0.01, ())
    jac_idx = f._classify(sc, au, at, not stage)[0]
    ue, ud = _host_grids(f, dtype, stage)
    args = (f.form, ue, ud, sc, _host_tables(f, dtype), f.lattice,
            (f.origin, f.h_axes, f.q_off), jac_idx,
            Stage(au, at, None) if stage else None)
    ref = fs.set_elem_full_plain(*args)
    a, res, jac, _keep = fs._elem_args(*args)
    lib = _host_build(f.form.source, tmp_path)
    assert _entry(lib, "set_elem_full", dtype)(ctypes.addressof(a),
                                                None) == 0
    for got, want in zip((res, jac), ref):
        _assert_close(got, want, dtype)


@pytest.fixture(scope="module")
def state_sets(tmp_path_factory):
    """(mesh, stage) -> (the provider of thermal_cdr_affine_cfg's affine
    set on its own small grid, the set's generated library built once for
    the host): the form and its source do not depend on the grid or the
    quadrature."""
    from torch_port_utils import thermal_cdr_affine_cfg
    cache = {}

    def get(mesh, stage):
        if (mesh, stage) not in cache:
            f = _host_provider(thermal_cdr_affine_cfg(mesh, stage))
            assert f._detect_affine(not stage)
            lib = _host_build(f.form.source, tmp_path_factory.mktemp(
                f"state_{mesh}_{int(stage)}"))
            cache[mesh, stage] = (f, lib)
        return cache[mesh, stage]
    return get


def _state_geometry(mesh, dims, dtype, quadrature):
    """(QuadTables, Lattice, (origin, h_axes, q_off)) of a uniform grid of
    `dims` elements on the unit box: 2D p1 or p2 quads, or hex."""
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_elem import basis_lattice
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    cell, order = {"p1": ("quad", 1), "hex": ("hex", 1),
                   "p2": ("quad", 2)}[mesh]
    h = tuple(1.0 / n for n in dims)
    disc = Discretization(box_mesh(cell, **dict(zip(("xmax", "ymax",
                                                      "zmax"), h))),
                          [("e", "HGRAD", order)], quadrature)
    key = ("HGRAD", order)
    tab = QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                     disc.wts[0], "cpu", dtype)
    return tab, basis_lattice(cell, order), ((0.0,) * len(dims), h,
                                             np.asarray(disc.ip[0]))


# set_node_state's and set_elem_state's cases: (mesh, element grid or
# None for the provider's own, stage, dtype, quadrature or None for the
# deck's): the provider's grid (4x4, hex 3x2x2, p2 3x3), grids of several
# tiles or blocks whose last ones are partial (2D p1 37 x 70 and 70 x 37:
# 3 x 3 and 5 x 2 walk tiles of 15 x 31 nodes; hex 9x7x5 and p2 19x15:
# 315 and 285 elements, three blocks of 128 on two resident blocks) and a
# 1-element grid, steady and at a stage, both precisions, at the decks'
# quadrature; at quadrature 4 (2D p1 Q = 9, hex Q = 27) the largest grid
# in f64
_STATE_GRIDS = {"p1": (None, (37, 70), (70, 37), (1, 1)),
                "hex": (None, (9, 7, 5), (1, 1, 1)),
                "p2": (None, (19, 15), (1, 1))}
STATE_HOST = [(m, g, s, d, None) for m in ("p1", "hex", "p2")
              for g in _STATE_GRIDS[m] for s in (False, True)
              for d in (torch.float64, torch.float32)] \
    + [(m, _STATE_GRIDS[m][1], s, torch.float64, 4) for m in ("p1", "hex")
       for s in (False, True)]


def _state_id(case):
    mesh, dims, stage, dtype, quadrature = case
    d = int(dtype == torch.float32)
    if dims is None:  # the provider's own grid
        return f"dtype{d}-{stage}-{mesh}"
    q = "" if quadrature is None else f"-q{quadrature}"
    return f"dtype{d}-{stage}-{mesh}-{'x'.join(map(str, dims))}{q}"


@pytest.mark.parametrize("mesh,dims,stage,dtype,quadrature", STATE_HOST,
                         ids=[_state_id(c) for c in STATE_HOST])
def test_state_kernels_on_the_host(state_sets, mesh, dims, stage, dtype,
                                   quadrature):
    """set_node_state (2D p1: the tile walk over both variables' grids)
    and set_elem_state (hex, p2: a thread per element on a persistent
    grid of 2 blocks), mode "state" of an affine thermal + cdr set whose
    kappa = 1 + 0.5 x makes the state part vary by element (the
    densities' derivative along the state, from the u grid alone), on the
    host against their plain versions: the provider's grid, grids of
    several tiles or blocks with a partial last one on each axis, a
    1-element grid, steady and at a DIRK-2,2 stage, at the decks'
    quadrature and at quadrature 4: f64 to 1e-12, f32 to 1e-5 of max
    |plain|."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    f, lib = state_sets(mesh, stage)
    st = Stage(0.5, 20.0, None) if stage else None
    sc = fs.SetScalars(0.1, 0.05, ())
    if dims is None:
        u, _ = _host_grids(f, dtype, False)
        tab, lat = _host_tables(f, dtype), f.lattice
        geo = (f.origin, f.h_axes, f.q_off)
    else:
        tab, lat, geo = _state_geometry(
            mesh, dims, dtype, quadrature or (4 if mesh == "p2" else 2))
        rng = np.random.RandomState(23)
        u = torch.as_tensor(rng.rand(f.nv, *(lat.stride * n + 1
                                             for n in dims)) - 0.5,
                            dtype=dtype)
    if quadrature is not None:
        assert tab.Q == {"p1": 9, "hex": 27}[mesh]
    if mesh == "p1":
        want = fs.set_node_state_plain(f.form, u, sc, tab, geo, st)
        a, got, _jac, _keep = fs._node_args(f.form, u, None, sc, tab, geo,
                                            (), st, True)
        name = "set_node_state"
    else:
        want = fs.set_elem_state_plain(f.form, u, sc, tab, lat, geo, st)
        a, got, _jac, _keep = fs._elem_args(f.form, u, None, sc, tab, lat,
                                            geo, (), st, lin=True)
        name = "set_elem_state"
    got.fill_(float("nan"))
    assert _entry(lib, name, dtype)(ctypes.addressof(a), None) == 0
    assert bool(torch.isfinite(got).all())
    _assert_close(got, want, dtype)


# (mesh, quadrature, stage, dtype): Q = 8 / 9 in both precisions, Q = 64
# in f64
NS_HOST_CASES = [(m, None, s, d) for m in ("hex", "p2") for s in (False, True)
                 for d in (torch.float64, torch.float32)] \
    + [("hex", 6, s, torch.float64) for s in (False, True)]


@pytest.mark.parametrize("mesh,quadrature,stage,dtype", NS_HOST_CASES)
def test_ns_elem_kernel_on_the_host(mesh, quadrature, stage, dtype,
                                    tmp_path):
    """ns_elem_full's kernel (fused_elem_ns.cu on the element-tile engine:
    its linearization once per (element, qp) and its contraction with
    the basis tables) against its plain version on the hex (Q = 8, and Q
    = 64 at quadrature 6, whose qps take several linearization chunks)
    and p2 (Q = 9) channel, steady with PSPG and at a DIRK-2,2 stage with
    PSPG + SUPG, with an (E, Q) viscosity, on element grids whose last
    block is partial: f64 to 1e-12, f32 to 1e-5 of max |plain|."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops._launch import SMEM_OPTIN, elem_smem_words
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from torch_port_utils import ns_elem_cfg
    dims = (5, 3, 2) if mesh == "hex" else (7, 5)
    f = _host_provider(ns_elem_cfg(mesh, dims, supg=stage), quadrature,
                       stage)
    assert isinstance(f, fn.FusedNSAssembly) and not f.node
    assert f.tables.Q == {"hex": 64 if quadrature else 8, "p2": 9}[mesh]
    E, Q = math.prod(dims), f.tables.Q
    rng = np.random.RandomState(23)
    visc = torch.as_tensor(0.1 + 0.05 * rng.rand(E, Q), dtype=dtype)
    coeffs = (1.0, visc, 1.0) + (0.0,) * (f.dim - 1)
    form = fn.NSForm(True, stage, f.h, 0.01 if stage else 1.0, stage)
    au, at = (0.5, 200.0) if stage else (1.0, 0.0)
    jac_idx = f._classify(coeffs, form, au, at, not stage)[0]
    ue, ud = _host_grids(f, dtype, stage)
    args = (ue, ud, coeffs, _host_tables(f, dtype), f.lattice, form,
            jac_idx, Stage(au, at, None) if stage else None)
    ref = fn.ns_elem_full_plain(*args)
    a, res, jac, _keep = fn._ns_elem_args(*args)
    # the last block holds fewer elements than the others: the engine
    # takes as many as the tiles fill 128 threads, and the layout fits
    el = min(16, 128 // a.n_tiles)
    while elem_smem_words(f.dim, f.nc, f.nv, stage, Q, el) \
            * dtype.itemsize > SMEM_OPTIN:
        el -= 1
    assert E % el != 0, (E, el)
    lib = _host_build('#include "fused_elem_ns.cu"\n', tmp_path)
    assert _entry(lib, "ns_elem_full", dtype)(ctypes.addressof(a),
                                               None) == 0
    for got, want in zip((res, jac), ref):
        _assert_close(got, want, dtype)


def _kink_cfg(mesh):
    """thermal + cdr with reaction sqrt(c) (an infinite derivative at c =
    0) and a thermal diffusion 1 + e^2 + abs(c) + max(c, 0) (abs at 0, max
    at a tie), on hex 3x2x2 or p2 3x2."""
    cfg = cdr_cfg(3, 2, 2, reaction="sqrt(c)") if mesh == "hex" \
        else cdr_cfg(3, 2, order=2, reaction="sqrt(c)")
    cfg["Physics"]["modules"] = "thermal,cdr"
    cfg["Discretization"]["order"]["e"] = 2 if mesh == "p2" else 1
    cfg["Functions"]["thermal diffusion"] = "1.0 + e*e + abs(c) + max(c, 0)"
    return cfg


@pytest.mark.parametrize("mesh", ["hex", "p2"])
def test_infinite_derivative_reaches_only_its_columns(mesh, tmp_path):
    """The engine's qp-input tangents keep JAX's sparse-AD conventions:
    at c = 0 everywhere, sqrt(c)'s infinite derivative reaches the
    columns of c alone, as infinities (and NaNs where a basis function is
    0 at a qp, as in JAX's column tangent alpha_u phi_c'(q) D), never the
    columns of e, so the contraction forms no NaN from a structural zero
    of D times an infinity; abs(c) at 0 and max(c, 0) at the tie follow
    JAX. set_elem_full on the host against its plain version: the same
    non-finite entries, and the finite ones to 1e-12 of max |plain|."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    f = _host_provider(_kink_cfg(mesh))
    assert isinstance(f, fs.FusedSetAssembly)
    assert tuple(f.form.variables) == ("e", "c")
    sc = fs.SetScalars(0.0, 1.0, ())
    jac_idx = f._classify(sc, 1.0, 0.0, True)[0]
    ue, _ = _host_grids(f, torch.float64, False)
    ue[1] = 0.0
    args = (f.form, ue, None, sc, _host_tables(f, torch.float64), f.lattice,
            (f.origin, f.h_axes, f.q_off), jac_idx, None)
    ref = fs.set_elem_full_plain(*args)
    a, res, jac, _keep = fs._elem_args(*args)
    lib = _host_build(f.form.source, tmp_path)
    assert _entry(lib, "set_elem_full", torch.float64)(
        ctypes.addressof(a), None) == 0
    nd, nc = f.nd, f.nc
    cols = torch.tensor([int(k) % nd // nc for k in jac_idx])
    for got, want in zip((res, jac), ref):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isposinf(got), torch.isposinf(want))
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        fin = torch.isfinite(want)
        assert float((got[fin] - want[fin]).abs().max()) <= \
            1e-12 * float(want[fin].abs().max())
    # every column of e is finite, and sqrt's derivative reached c's
    assert bool(torch.isfinite(jac[cols == 0]).all())
    assert not bool(torch.isfinite(jac[cols == 1]).all())
    if mesh == "p2":
        assert bool(torch.isnan(jac).any())


THERMAL_FULL_TU = """
#include "fused_elem_thermal.cu"
"""


def _thermal_tables(mesh, dims, quadrature=None):
    """(QuadTables f64 on the CPU, Lattice) of a uniform hex (p1) or quad
    (p2) grid of `dims` elements."""
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_elem import basis_lattice
    cell, order, quad = ("hex", 1, 2) if mesh == "hex" else ("quad", 2, 4)
    size = dict(zip(("xmax", "ymax", "zmax"), (1.0 / n for n in dims)))
    disc = Discretization(box_mesh(cell, **size), [("e", "HGRAD", order)],
                          quadrature or quad)
    key = ("HGRAD", order)
    return (disc.basis_vals[key], disc.basis_grads[key][0], disc.wts[0]), \
        basis_lattice(cell, order)


def _thermal_full_host(lib, dtype, grid, qp, tab, lat, stage, vel):
    """thermal_elem_full's C entry point of a host build on CPU tensors,
    its arguments filled as the wrapper fills them."""
    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops._launch import (ptr, stage_args,
                                              velocity_args)
    fn = getattr(lib, "thermal_elem_full_f64" if dtype == torch.float64
                 else "thermal_elem_full_f32")
    fn.argtypes = _build._SIGNATURES["thermal_elem_full_f64"]
    fn.restype = ctypes.c_int
    E = math.prod(fe.elem_dims(grid, lat))
    nc = len(lat.offsets)
    rows = torch.full((nc, E), float("nan"), dtype=dtype)
    jac = torch.full((nc * nc, E), float("nan"), dtype=dtype)
    err = fn(ptr(grid), *(ptr(t) for t in qp),
             *stage_args(stage, E, grid, tab),
             *velocity_args(vel, E, grid, tab),
             *fe._geometry_args(grid, tab, lat), ptr(rows), ptr(jac), None)
    assert err == 0
    return rows, jac


THERMAL_FULL_CASES = ("steady", "stage", "advect", "advect rotating stage")


@pytest.mark.parametrize("mesh", ["hex", "p2"])
@pytest.mark.parametrize("case", THERMAL_FULL_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("chunks", [False, True])
def test_thermal_elem_full_on_the_host(mesh, case, dtype, chunks,
                                       tmp_path):
    """thermal_elem_full (the qp scalars of a warp's 8 elements contracted
    with the weighted basis products in m8n8k4 fragments, each lane's FMA
    form of the step) on the host against its plain version: hex 5x4x7
    and p2 9x8 (several tiles of 64 elements on a persistent grid of 2
    blocks, the last tile partial), steady, a DIRK-2,2 stage with an (E,
    Q) mass, the velocity (2, 1[, 0.5]) and a per-qp one at a stage with
    m = 1; the fragments in one chunk, or (`chunks`) rebuilt per qp group
    under a small budget. f64 to 1e-12, f32 to 1e-5 of max |plain|."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables, Stage
    dims = (5, 4, 7) if mesh == "hex" else (9, 8)
    (phi, grad, wts), lat = _thermal_tables(mesh, dims)
    tab = QuadTables(phi, grad, wts, "cpu", dtype)
    E, Q = math.prod(dims), tab.Q
    rng = np.random.RandomState(31)
    shape = tuple(lat.stride * n + 1 for n in dims)
    grid = torch.as_tensor(rng.rand(*shape) - 0.5, dtype=dtype)
    S, dS, dK = (torch.as_tensor(rng.rand(E, Q) - 0.5, dtype=dtype)
                 for _ in range(3))
    K = torch.as_tensor(1.0 + rng.rand(E, Q), dtype=dtype)
    mass = torch.as_tensor(1.0 + rng.rand(E, Q), dtype=dtype)
    stage = None
    if "stage" in case:
        stage = Stage(0.29, 170.0, 1.0 if "advect" in case else mass)
    vel = None
    if case == "advect":
        vel = [2.0, 1.0, 0.5][:tab.dim]
    elif "advect" in case:
        vel = [torch.as_tensor(rng.rand(E, Q) - 0.5, dtype=dtype)
               for _ in range(tab.dim)]
    qp = (S, dS, K, dK)
    ref = fe.thermal_elem_full_plain(grid, *qp, tab, lat, stage, vel)
    source = ("#define THERMAL_FULL_FRAG_BYTES 4096\n" if chunks else "") \
        + THERMAL_FULL_TU
    lib = _host_build(source, tmp_path)
    got = _thermal_full_host(lib, dtype, grid, qp, tab, lat, stage, vel)
    for g, w in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        _assert_close(g, w, dtype)


@pytest.fixture(scope="module")
def elem_thermal_lib(tmp_path_factory):
    """fused_elem_thermal.cu built once for the host."""
    return _host_build(THERMAL_FULL_TU,
                       tmp_path_factory.mktemp("fused_elem_thermal"))


# thermal_elem_state's cases: steady, a stage and advection, with kappa
# ("k"), m ("m") and the velocity ("b") each a scalar, or in capitals one
# value per (element, qp); (case, mesh, grid, dtype, quadrature): a grid
# of several tiles of 64 elements whose last one is partial and a
# 1-element grid in both precisions at the decks' quadrature, and in f64
# at one more point per axis (hex Q = 27, p2 Q = 16)
ELEM_STATE_CASES = ("steady k", "steady K", "stage k m", "stage K M",
                    "stage k M", "advect k b", "advect K B",
                    "advect stage k m b", "advect stage K M B")
_ELEM_GRIDS = {"hex": ((5, 4, 7), (1, 1, 1)), "p2": ((9, 8), (1, 1))}
_ELEM_QUAD = {"hex": (2, 4), "p2": (4, 6)}
ELEM_STATE_HOST = [(c, m, g, d, _ELEM_QUAD[m][0]) for c in ELEM_STATE_CASES
                   for m in ("hex", "p2") for g in _ELEM_GRIDS[m]
                   for d in (torch.float64, torch.float32)] \
    + [(c, m, _ELEM_GRIDS[m][0], torch.float64, _ELEM_QUAD[m][1])
       for c in ELEM_STATE_CASES for m in ("hex", "p2")]


@pytest.mark.parametrize("case,mesh,dims,dtype,quadrature", ELEM_STATE_HOST)
def test_thermal_elem_state_on_the_host(elem_thermal_lib, case, mesh, dims,
                                        dtype, quadrature):
    """thermal_elem_state (the row role of the tile design: each lane's
    element linearized at its qps once, the qp scalars of a warp's octet
    contracted with the weighted basis products in m8n8k4 fragments, each
    lane's FMA form of the step, on a persistent grid of 2 blocks; f32 a
    thread per element over the per-qp products) on the host against its
    plain version: hex 5x4x7 and p2 9x8 (several tiles, the last one
    partial) and a 1-element grid, steady, at a DIRK-2,2 stage and with
    advection, kappa, m and b each a scalar or one value per (element,
    qp), at the decks' quadrature and one more point per axis: f64 to
    1e-12, f32 to 1e-5 of max |plain|."""
    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops._launch import (coeff_args, ptr, stage_args,
                                              velocity_args)
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables, Stage
    (phi, grad, wts), lat = _thermal_tables(mesh, dims, quadrature)
    tab = QuadTables(phi, grad, wts, "cpu", dtype)
    E, Q = math.prod(dims), tab.Q
    assert Q == {2: 8, 4: 27 if mesh == "hex" else 9, 6: 16}[quadrature]
    rng = np.random.RandomState(37)
    shape = tuple(lat.stride * n + 1 for n in dims)
    grid = torch.as_tensor(rng.rand(*shape) - 0.5, dtype=dtype)
    words = case.split()

    def per_qp(lo):
        return torch.as_tensor(lo + rng.rand(E, Q), dtype=dtype)
    kappa = per_qp(1.0) if "K" in words else 1.3
    stage = None
    if "stage" in words:
        stage = Stage(0.29, 170.0, per_qp(1.0) if "M" in words else 2.0)
    vel = None
    if "b" in words:
        vel = [2.0, -1.0, 0.5][:tab.dim]
    elif "B" in words:
        vel = [per_qp(-0.5) for _ in range(tab.dim)]
    want = fe.thermal_elem_state_plain(grid, kappa, tab, lat, stage, vel)
    name = "thermal_elem_state_f64" if dtype == torch.float64 \
        else "thermal_elem_state_f32"
    fnc = getattr(elem_thermal_lib, name)
    fnc.argtypes = _build._SIGNATURES[name]
    fnc.restype = ctypes.c_int
    got = torch.full((tab.nc, E), float("nan"), dtype=dtype)
    assert fnc(ptr(grid), *coeff_args(kappa, E, grid, tab, "kappa"),
               *stage_args(stage, E, grid, tab),
               *velocity_args(vel, E, grid, tab),
               *fe._geometry_args(grid, tab, lat), ptr(got), None) == 0
    assert bool(torch.isfinite(got).all())
    _assert_close(got, want, dtype)


@pytest.fixture(scope="module")
def node_libs(tmp_path_factory):
    """The two B2 node kernel files, fused_p1_thermal.cu and
    fused_p1_ns.cu, each built once for the host."""
    return {name: _host_build(f'#include "{name}"\n',
                              tmp_path_factory.mktemp(name[:-3]))
            for name in ("fused_p1_thermal.cu", "fused_p1_ns.cu")}


def _p1_tables(dims, dtype, quadrature=2):
    """QuadTables on the CPU of a uniform p1 quad grid of `dims` elements
    on the unit square."""
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    disc = Discretization(box_mesh("quad", nx=1, ny=1, xmax=1.0 / dims[0],
                                   ymax=1.0 / dims[1]),
                          [("e", "HGRAD", 1)], quadrature)
    key = ("HGRAD", 1)
    return QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                      disc.wts[0], "cpu", dtype)


# thermal_node_state's cases: steady, a stage and advection, with kappa
# ("k"), m ("m") and the velocity ("b") each a scalar, or in capitals one
# value per (element, qp)
NODE_STATE_CASES = ("steady k", "steady K", "stage k m", "stage K m",
                    "stage k M", "stage K M", "advect k b", "advect K b",
                    "advect k B", "advect stage k m b",
                    "advect stage K M B")
NODE_STATE_HOST = [(c, g, d, 2) for c in NODE_STATE_CASES
                   for g in ((37, 13), (13, 37), (1, 1))
                   for d in (torch.float64, torch.float32)] \
    + [(c, (37, 13), torch.float64, 4) for c in NODE_STATE_CASES]


@pytest.mark.parametrize("case,dims,dtype,quadrature", NODE_STATE_HOST)
def test_thermal_node_state_on_the_host(node_libs, case, dims, dtype,
                                        quadrature):
    """thermal_node_state (tiles of 16 x 32 elements and 15 x 31 nodes on a
    persistent grid of 2 blocks: the node patch staged, each element's
    quadrature once, each node the sum of its four elements' rows) on the
    host against its plain version, steady, at a DIRK-2,2 stage and with
    advection, kappa, m and b each a scalar or one value per (element,
    qp), on 37 x 13 and 13 x 37 grids (several tiles along one axis, the
    last ones partial) and a 1 x 1 grid, at Q = 4 (the compile-time
    instance) and Q = 9: f64 to 1e-12, f32 to 1e-5 of max |plain|."""
    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.ops._launch import (coeff_args, stage_args,
                                              velocity_args)
    tab = _p1_tables(dims, dtype, quadrature)
    E, Q = math.prod(dims), tab.Q
    assert Q == {2: 4, 4: 9}[quadrature]
    rng = np.random.RandomState(41)
    u = torch.as_tensor(rng.rand(dims[0] + 1, dims[1] + 1) - 0.5,
                        dtype=dtype)
    words = case.split()

    def per_qp(lo):
        return torch.as_tensor(lo + rng.rand(E, Q), dtype=dtype)
    kappa = per_qp(1.0) if "K" in words else 1.3
    stage = None
    if "stage" in words:
        stage = fp.Stage(0.29, 170.0, per_qp(1.0) if "M" in words else 2.0)
    vel = None
    if "b" in words:
        vel = [2.0, -1.0]
    elif "B" in words:
        vel = [per_qp(-0.5), per_qp(-0.5)]
    want = fp.thermal_node_state_plain(u, kappa, tab, stage, vel)
    name = "thermal_node_state_f64" if dtype == torch.float64 \
        else "thermal_node_state_f32"
    fnc = getattr(node_libs["fused_p1_thermal.cu"], name)
    fnc.argtypes = _build._SIGNATURES[name]
    fnc.restype = ctypes.c_int
    got = torch.full_like(u, float("nan"))
    assert fnc(u.data_ptr(), *coeff_args(kappa, E, u, tab, "kappa"),
               *stage_args(stage, E, u, tab), *velocity_args(vel, E, u, tab),
               tab.t_phi.data_ptr(), tab.t_grad.data_ptr(),
               tab.t_wts.data_ptr(), Q, *dims, got.data_ptr(), None) == 0
    assert bool(torch.isfinite(got).all())
    _assert_close(got, want, dtype)


# thermal_node_full's cases: steady, a stage and advection, with m and the
# velocity ("b") each a scalar, or in capitals one value per (element,
# qp); S, dS, K, dK are always per qp
NODE_FULL_CASES = ("steady", "stage m", "stage M", "advect b", "advect B",
                   "advect stage m b", "advect stage M B")
NODE_FULL_HOST = [(c, g, d, 2) for c in NODE_FULL_CASES
                  for g in ((37, 13), (13, 37), (1, 1))
                  for d in (torch.float64, torch.float32)] \
    + [(c, (37, 13), torch.float64, 4) for c in NODE_FULL_CASES]


@pytest.mark.parametrize("case,dims,dtype,quadrature", NODE_FULL_HOST)
def test_thermal_node_full_on_the_host(node_libs, case, dims, dtype,
                                       quadrature):
    """thermal_node_full (thermal_node_state's tile walk with a Jacobian
    role: each element's quadrature once, its qp scalars contracted with
    the weighted basis products built once per block, each node the sum of
    its four elements' rows, each element's 16 Jacobian rows written by
    the tile that owns it) on the host against its plain version, steady,
    at a DIRK-2,2 stage and with advection, m and b each a scalar or one
    value per (element, qp), on 37 x 13 and 13 x 37 grids (several tiles
    along one axis, the last ones partial) and a 1 x 1 grid, at Q = 4
    (the compile-time instance) and Q = 9: f64 to 1e-12, f32 to 1e-5 of
    max |plain|, the residual and every Jacobian row."""
    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.ops._launch import stage_args, velocity_args
    tab = _p1_tables(dims, dtype, quadrature)
    E, Q = math.prod(dims), tab.Q
    assert Q == {2: 4, 4: 9}[quadrature]
    rng = np.random.RandomState(43)
    u = torch.as_tensor(rng.rand(dims[0] + 1, dims[1] + 1) - 0.5,
                        dtype=dtype)
    words = case.split()

    def per_qp(lo):
        return torch.as_tensor(lo + rng.rand(E, Q), dtype=dtype)
    S, dS, dK = per_qp(-0.5), per_qp(-0.5), per_qp(-0.5)
    K = per_qp(1.0)
    stage = None
    if "stage" in words:
        stage = fp.Stage(0.29, 170.0, per_qp(1.0) if "M" in words else 2.0)
    vel = None
    if "b" in words:
        vel = [2.0, -1.0]
    elif "B" in words:
        vel = [per_qp(-0.5), per_qp(-0.5)]
    want = fp.thermal_node_full_plain(u, S, dS, K, dK, tab, stage, vel)
    name = "thermal_node_full_f64" if dtype == torch.float64 \
        else "thermal_node_full_f32"
    fnc = getattr(node_libs["fused_p1_thermal.cu"], name)
    fnc.argtypes = _build._SIGNATURES[name]
    fnc.restype = ctypes.c_int
    got = (torch.full_like(u, float("nan")),
           torch.full((16, E), float("nan"), dtype=dtype))
    assert fnc(u.data_ptr(), S.data_ptr(), dS.data_ptr(), K.data_ptr(),
               dK.data_ptr(), *stage_args(stage, E, u, tab),
               *velocity_args(vel, E, u, tab), tab.t_phi.data_ptr(),
               tab.t_grad.data_ptr(), tab.t_wts.data_ptr(), Q, *dims,
               got[0].data_ptr(), got[1].data_ptr(), None) == 0
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _assert_close(g, w, dtype)


# ns_node_full's cases: (case, quadrature, grid, dtype)
NS_NODE_HOST = [(c, q, g, d) for c in ("steady", "steady visc", "stage")
                for q in (2, 8) for g in ((37, 13), (32, 16), (1, 1))
                for d in (torch.float64, torch.float32)]
_NS_NODE_PROVIDERS = {}


@pytest.mark.parametrize("case,quadrature,dims,dtype", NS_NODE_HOST)
def test_ns_node_kernel_on_the_host(node_libs, case, quadrature, dims,
                                    dtype):
    """ns_node_full (8 x 16 node tiles, a thread per own element: one pass
    of the density per (qp, column variable) contracted in registers, the
    first pass's values summing the element's residual rows; the 25 halo
    elements' primal densities; each node the sum of its four elements'
    rows) on the host against its plain version on the channel: PSPG
    steady with viscosity 1 and with one value per (element, qp), and
    PSPG + SUPG at a DIRK-2,2 stage, at Q = 4 and Q = 25, on a 37 x 13
    grid (its last tiles partial), a 32 x 16 one (its last tile row and
    column hold nodes only) and a 1 x 1 grid: f64 to 1e-12, f32 to 1e-5
    of max |plain|."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    stage = case == "stage"
    key = (dims, quadrature, stage)
    if key not in _NS_NODE_PROVIDERS:
        _NS_NODE_PROVIDERS[key] = _host_provider(
            channel_cfg(*dims, supg=stage), quadrature, stage)
    f = _NS_NODE_PROVIDERS[key]
    assert isinstance(f, fn.FusedNSAssembly) and f.node
    assert f.tables.Q == {2: 4, 8: 25}[quadrature]
    E, Q = math.prod(dims), f.tables.Q
    rng = np.random.RandomState(29)
    visc = torch.as_tensor(0.1 + 0.05 * rng.rand(E, Q), dtype=dtype) \
        if case == "steady visc" else 1.0
    coeffs = (1.0, visc, 1.0, 0.0)
    form = fn.NSForm(True, stage, f.h, 0.01 if stage else 1.0, stage)
    au, at = (0.5, 200.0) if stage else (1.0, 0.0)
    jac_idx = f._classify(coeffs, form, au, at, not stage)[0]
    ue, ud = _host_grids(f, dtype, stage)
    args = (ue, ud, coeffs, _host_tables(f, dtype), form, jac_idx,
            Stage(au, at, None) if stage else None)
    want = fn.ns_node_full_plain(*args)
    a, res, jac, _keep = fn._ns_node_args(*args)
    assert _entry(node_libs["fused_p1_ns.cu"], "ns_node_full", dtype)(
        ctypes.addressof(a), None) == 0
    for got, ref in zip((res, jac), want):
        assert bool(torch.isfinite(got).all())
        _assert_close(got, ref, dtype)


@pytest.mark.parametrize("case", ["thermal_node_state",
                                  "thermal_node_full",
                                  "thermal_node_full without advection",
                                  "ns_node_full"])
def test_node_kernels_refuse_a_quadrature_past_the_card(case):
    """The providers of the B2 node kernels accept a 2D p1 deck's
    quadrature only where the kernel's block fits the H100's shared
    memory per block (ns_node_full: the halo's densities, f64 up to 122
    qps; thermal_node_state: its tables, f64 up to 1,833 qps;
    thermal_node_full: its tables and products, of the instance the deck
    launches: f64 up to 196 qps with advection, 256 without), and past
    that raise a ValueError that names the limit."""
    from mrhyde_tpu_torch.ops._launch import (SMEM_OPTIN, full_smem_words,
                                              ns_node_smem_words,
                                              state_smem_words)
    kernel = case.split()[0]
    cfg, words, fits, past = {
        "thermal_node_state": (lambda: thermal_cfg(2), state_smem_words,
                               (83,), 85),
        "thermal_node_full": (lambda: cdr_cfg(2, reaction="0.5*c*c"),
                              lambda Q: full_smem_words(Q, True),
                              (27,), 29),
        "thermal_node_full without advection": (
            lambda: thermal_cfg(2, kappa="1.0 + e*e"),
            lambda Q: full_smem_words(Q, False), (28, 30), 32),
        "ns_node_full": (lambda: channel_cfg(2, 1), ns_node_smem_words,
                         (21,), 23)}[case]
    for quadrature in fits:
        f = _host_provider(cfg(), quadrature)
        assert words(f.tables.Q) * 8 <= SMEM_OPTIN
    # the last quadrature that fits, then the first one past the card
    assert words(f.tables.Q) * 8 <= SMEM_OPTIN < words(
        (f.tables.Q ** 0.5 + 1) ** 2) * 8
    with pytest.raises(ValueError, match=f"{kernel} at .* shared memory"):
        _host_provider(cfg(), past)


LAYOUT_TU = {
    "set_node.cuh": """
#include "set_node.cuh"
template <int NV> long long w(int tr, int Q, int el) {
  return tr ? SetLayout<NV, true>::total(Q, el)
            : SetLayout<NV, false>::total(Q, el);
}
extern "C" long long words(int dim, int nc, int nv, int tr, int Q, int el) {
  switch (nv) {
    case 1: return w<1>(tr, Q, el);
    case 2: return w<2>(tr, Q, el);
    case 3: return w<3>(tr, Q, el);
    case 4: return w<4>(tr, Q, el);
    default: return w<5>(tr, Q, el);
  }
}
extern "C" long long state_words(int dim, int nc, int nv, int Q) {
  return set_state_words(nv, Q);
}
""",
    "set_elem.cuh": """
#include "set_elem.cuh"
template <int D, int C, int NV> long long w(int tr, int Q, int el) {
  return tr ? ElemLayout<D, C, NV, true>::total(Q, el)
            : ElemLayout<D, C, NV, false>::total(Q, el);
}
template <int D, int C> long long wn(int nv, int tr, int Q, int el) {
  switch (nv) {
    case 1: return w<D, C, 1>(tr, Q, el);
    case 2: return w<D, C, 2>(tr, Q, el);
    case 4: return w<D, C, 4>(tr, Q, el);
    case 5: return w<D, C, 5>(tr, Q, el);
    default: return w<D, C, 6>(tr, Q, el);
  }
}
extern "C" long long words(int dim, int nc, int nv, int tr, int Q, int el) {
  return dim == 3 ? wn<3, 8>(nv, tr, Q, el) : wn<2, 9>(nv, tr, Q, el);
}
extern "C" long long state_words(int dim, int nc, int nv, int Q) {
  return dim == 3 ? ElemStateQp<3, 8>::words(Q) : ElemStateQp<2, 9>::words(Q);
}
""",
    "fused_elem_ns.cu": """
#include "fused_elem_ns.cu"
extern "C" long long words(int dim, int nc, int nv, int tr, int Q, int el) {
  if (dim == 3) return tr ? ElemLayout<3, 8, 4, true>::total(Q, el)
                          : ElemLayout<3, 8, 4, false>::total(Q, el);
  return tr ? ElemLayout<2, 9, 3, true>::total(Q, el)
            : ElemLayout<2, 9, 3, false>::total(Q, el);
}
""",
    "fused_p1_thermal.cu": """
#include "fused_p1_thermal.cu"
extern "C" long long words(int dim, int nc, int nv, int tr, int Q, int el) {
  return nv == 1 ? state_smem_words(Q) : full_smem_words(Q, nv == 3);
}
""",
    "fused_p1_ns.cu": """
#include "fused_p1_ns.cu"
extern "C" long long words(int dim, int nc, int nv, int tr, int Q, int el) {
  return ns_smem_words(Q);
}
""",
}


@pytest.mark.parametrize("header", list(LAYOUT_TU))
def test_layout_formulas_are_the_kernels(header, tmp_path):
    """ops/_launch.py's shared-memory formulas, which the providers check
    a deck's quadrature against, equal the kernels' own layouts (the
    headers built on the host) at every element count, quadrature and
    set size; so do those of the sets' state kernels (set_node_state,
    set_elem_state)."""
    from mrhyde_tpu_torch.ops._launch import (elem_smem_words,
                                              elem_state_smem_words,
                                              full_smem_words,
                                              node_smem_words,
                                              ns_node_smem_words,
                                              set_state_smem_words,
                                              state_smem_words)
    lib = _host_build(LAYOUT_TU[header], tmp_path)
    lib.words.restype = ctypes.c_longlong
    if header in ("set_node.cuh", "set_elem.cuh"):
        lib.state_words.restype = ctypes.c_longlong
    cases = {"set_node.cuh": [(2, 4, nv) for nv in (1, 2, 3, 4, 5)],
             "set_elem.cuh": [(d, c, nv) for d, c in ((3, 8), (2, 9))
                              for nv in (1, 2, 4, 5, 6)],
             "fused_elem_ns.cu": [(3, 8, 4), (2, 9, 3)],
             "fused_p1_thermal.cu": [(2, 4, 1), (2, 4, 2), (2, 4, 3)],
             "fused_p1_ns.cu": [(2, 4, 3)]}[header]
    # the node kernels' layouts depend on Q alone (fused_p1_thermal.cu: nv
    # 1 selects thermal_node_state's, 2 and 3 thermal_node_full's without
    # and with advection)
    node = {"fused_p1_thermal.cu": lambda Q, nv: state_smem_words(Q)
            if nv == 1 else full_smem_words(Q, nv == 3),
            "fused_p1_ns.cu": lambda Q, nv: ns_node_smem_words(Q)}.get(header)
    for dim, nc, nv in cases:
        for tr in (0, 1):
            for Q in (1, 4, 8, 9, 25, 27, 64, 125):
                for el in (1, 2, 4, 8, 16):
                    if node:
                        want = node(Q, nv)
                    elif nc == 4:
                        want = node_smem_words(nv, tr, Q, el)
                    else:
                        want = elem_smem_words(dim, nc, nv, tr, Q, el)
                    assert lib.words(dim, nc, nv, tr, Q, el) == want
                if header == "set_node.cuh":
                    assert lib.state_words(dim, nc, nv, Q) == \
                        set_state_smem_words(nv, Q)
                elif header == "set_elem.cuh":
                    assert lib.state_words(dim, nc, nv, Q) == \
                        elem_state_smem_words(dim, nc, Q)


@pytest.mark.parametrize("kind", ["ns_hex", "ns_p2", "set_node",
                                  "set_hex"])
def test_every_accepted_quadrature_fits_the_card(kind):
    """The NS and set providers accept a deck's quadrature only where one
    element's layout fits the H100's shared memory per block (for a set,
    that of mode "full"; these sets are not affine, so they never launch
    a state kernel, whose layout an affine set's first state launch
    checks: tests/test_torch_fused_set_ns.py), so the kernels never fail
    to launch for it; past that they raise a clear ValueError, never
    taking the general path in silence."""
    from mrhyde_tpu_torch.ops._launch import (SMEM_OPTIN, block_elems,
                                              elem_smem_words,
                                              node_smem_words)
    from torch_port_utils import channel_cfg, ns_elem_cfg, \
        ns_thermal_elem_cfg
    build = {"ns_hex": lambda: ns_elem_cfg("hex", (2, 1, 1)),
             "ns_p2": lambda: ns_elem_cfg("p2", (2, 1)),
             "set_node": lambda: channel_cfg(2, 1, visc="1.0 + ux*ux"),
             "set_hex": lambda: ns_thermal_elem_cfg("hex", (2, 1, 1))}[kind]
    accepted = 0
    for degree in (2, 4, 6, 8, 10, 14, 20, 28, 40, 60, 90):
        for transient in (False, True):
            try:
                f = _host_provider(build(), degree, transient)
            except ValueError as e:
                assert "shared memory" in str(e)
                continue
            accepted += 1
            Q, tr = f.tables.Q, transient
            if kind == "set_node":
                words = lambda el: node_smem_words(  # noqa: E731
                    f.nv, tr, Q, el)
            else:
                words = lambda el: elem_smem_words(  # noqa: E731
                    len(f.dims), f.nc, f.nv, tr, Q, el)
            assert block_elems(words, 8, SMEM_OPTIN) >= 1
    assert 4 <= accepted < 22

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
import os
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
    nv = len(form.variables)
    nq = 4 * nv
    no = 3 * nv
    return PRELUDE + "namespace {\n" + codegen.density_struct(
        form.modules, form.variables, form.params, form.fm) + f"""
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
    D u[{nv}], ud[{nv}], g[{nv}][2], o[{no}];
    for (int v = 0; v < {nv}; ++v) {{
      u[v].v = s[v]; u[v].d[0] = d[v];
      ud[v].v = s[{nv} + v]; ud[v].d[0] = d[{nv} + v];
      for (int k = 0; k < 2; ++k) {{
        g[v][k].v = s[{2 * nv} + 2 * v + k];
        g[v][k].d[0] = d[{2 * nv} + 2 * v + k];
      }}
    }}
    if (tr) GenDensity::eval<true, D>(u, ud, g, xy[2 * i], xy[2 * i + 1],
                                      a, o);
    else GenDensity::eval<false, D>(u, ud, g, xy[2 * i], xy[2 * i + 1],
                                    a, o);
    for (int k = 0; k < {no}; ++k) {{
      out[i * {2 * no} + k] = o[k].v;
      out[i * {2 * no} + {no} + k] = o[k].d[0];
    }}
  }}
}}
"""


@pytest.mark.parametrize("name", ["ns_thermal", "ns_cdr", "thermal_cdr",
                                  "cdr_state", "ns_visc"])
@pytest.mark.parametrize("transient", [False, True])
def test_generated_density_matches_plain(name, transient, tmp_path):
    """The generated density (a column's Dual<T, 1> pass of the kernel)
    against the plain version's summed module densities with
    torch.func.jvp, at seeded states, coordinates and tangents."""
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly, \
        SetScalars, _density
    from mrhyde_tpu_torch.problem import Problem
    cfg = _set_cfgs()[name]
    if transient:
        cfg["Solver"] = {"solver": "transient", "final time": 0.04,
                         "number of steps": 4}
    fused = Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    assert isinstance(fused, FusedSetAssembly)
    form = fused.form
    lib = _compile(_density_source(form), tmp_path, "density")
    nv = len(form.variables)
    n = 7
    rng = np.random.RandomState(7)
    st = rng.uniform(-1.0, 1.0, (n, 4 * nv))
    tg = rng.uniform(-1.0, 1.0, (n, 4 * nv))
    if not transient:
        st[:, nv:2 * nv] = 0.0
        tg[:, nv:2 * nv] = 0.0
    xy = rng.uniform(0.0, 1.0, (n, 2))
    sc = SetScalars(0.3, 0.01, ())
    scal = np.zeros(32)
    scal[:3 + len(form.params)] = form.scalars(sc)
    ns = form.ns
    out = np.zeros((n, 6 * nv))
    dbl = ctypes.POINTER(ctypes.c_double)
    lib.density(ctypes.c_int(n), *(np.ascontiguousarray(a).ctypes.data_as(
        dbl) for a in (st, tg, xy, scal)), ctypes.c_double(form.h),
        ctypes.c_double(form.tau_dt2(sc.deltat)),
        ctypes.c_int(int(bool(ns and ns.use_pspg))),
        ctypes.c_int(int(bool(ns and ns.use_supg))),
        ctypes.c_int(int(transient)), out.ctypes.data_as(dbl))
    xt = torch.as_tensor(xy)
    dens = _density(form, lambda _q: [xt[:, 0], xt[:, 1]], sc)

    def f(z):
        u = [z[:, v] for v in range(nv)]
        ud = [z[:, nv + v] for v in range(nv)] if transient \
            else [0.0] * nv
        g = [[z[:, 2 * nv + 2 * v + d] for d in range(2)]
             for v in range(nv)]
        return torch.stack([torch.broadcast_to(torch.as_tensor(
            o, dtype=torch.float64), (n,)) for o in dens(0, u, ud, g)],
            dim=1)
    val, tan = torch.func.jvp(f, (torch.as_tensor(st),),
                              (torch.as_tensor(tg),))
    no = 3 * nv
    scale = 1.0 + float(val.abs().max())
    assert np.max(np.abs(out[:, :no] - val.numpy())) <= 1e-13 * scale
    tscale = 1.0 + float(tan.abs().max())
    assert np.max(np.abs(out[:, no:] - tan.numpy())) <= 1e-13 * tscale

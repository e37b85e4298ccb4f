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
# set_elem.cuh's kernel template run on the host: one std::thread per
# CUDA thread of a block, a barrier for __syncthreads, the block's shared
# memory a host buffer (filled with NaN bytes, so a read of a slot no
# thread wrote shows); the launch line and the shared-memory declaration
# are the two lines rewritten for the host
# ----------------------------------------------------------------------

HOST_CUDA = """
#pragma once
#include <math.h>
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
struct HostIdx { unsigned x; };
inline thread_local HostIdx threadIdx, blockIdx;
inline std::barrier<>* host_barrier = nullptr;
inline unsigned char* host_smem = nullptr;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
template <class K, class... A>
void host_launch(K kernel, unsigned blocks, int threads, size_t smem,
                 A... args) {
  std::vector<unsigned char> buf(smem);
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
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
"""
HOST_REWRITES = (
    ("extern __shared__ __align__(16) unsigned char smem_raw[];",
     "unsigned char* smem_raw = host_smem;"),
    ("kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>"
     "(a, geo);", "host_launch(kernel, (unsigned)blocks, kThreads, smem, "
     "a, geo);"),
)


def _host_kernel(form, tmp_path):
    """The deck's generated set_elem_full source built for the host."""
    text = open(os.path.join(CSRC, "set_elem.cuh")).read()
    for old, new in HOST_REWRITES:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    (tmp_path / "set_elem.cuh").write_text(text)
    (tmp_path / "cuda_runtime.h").write_text(HOST_CUDA)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel on the "
                    "CPU")
    src, lib = tmp_path / "gen.cpp", tmp_path / "libgen.so"
    src.write_text(form.source)
    out = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                          "-pthread", "-Wno-unknown-pragmas", "-I",
                          str(tmp_path), "-I", CSRC, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if out.returncode != 0 and "barrier" in out.stderr:
        pytest.skip("the host C++ library has no std::barrier (C++20)")
    assert out.returncode == 0, out.stderr[-4000:]
    return ctypes.CDLL(str(lib))


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
    a, res, jac = fs._elem_args(*args)
    lib = _host_kernel(f.form, tmp_path)
    fn = getattr(lib, "set_elem_full_f64" if dtype == torch.float64
                 else "set_elem_full_f32")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    assert fn(ctypes.addressof(a), None) == 0
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    for got, want in zip((res, jac), ref):
        assert float((got - want).abs().max()) <= \
            rtol * float(want.abs().max())

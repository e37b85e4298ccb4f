"""C++ code of the function DSL's expressions, for the generated kernels.

The module-set kernels (ops/csrc/set_node.cuh on 2D p1 quads,
ops/csrc/set_elem.cuh on 3D hex and 2D p2 quads) evaluate each deck's
coefficient expressions inside the kernel, as the JAX package's kernel
traces them: `expr_code` turns an `Expr` AST (functions/parser.py), with
the deck's named functions inlined through the FunctionManager, into a
C++ expression over the kernel's scalar type `S` (a plain T or a
Dual<T, 1> of csrc/dual.cuh), and `density_source` writes the whole
generated translation unit of one deck: its coefficients, the modules'
densities (in the deck's dimension) and the kernel's entry points.

Node by node:
- numbers: `T(...)` literals with 17 significant digits; `pi` and every
  constant subtree fold here, with the port's evaluator (Python floats,
  as JAX folds them at trace time);
- `x`, `y` (and `z` in 3D): the quadrature point's coordinates (kernel
  arguments of the density); `t` and the deck's scalar parameters:
  kernel arguments, so a new time or step size rebuilds nothing;
- a variable name: the state at the point, of type S, so duals carry
  the derivative;
- + - * / and unary minus: C++ operators; ^ and the DSL's functions:
  `ad_pow`, `ad_sin`, ... of dual.cuh (their rules are JAX's sparse
  forward AD's); < >: `ad_lt`, `ad_gt` (1 or 0, no tangent).

What has no C++ form here raises `Unsupported` (gradients `grad(u)[x]`,
time derivatives `u_t`, `z` in 2D, `emax` / `emin` / `emean`, indexed
parameters): the provider then leaves the deck to its other routes.
"""

from __future__ import annotations

import hashlib

from mrhyde_tpu_torch.functions.parser import Expr

__all__ = ["Unsupported", "expr_code", "inline", "leaf_coder",
           "density_struct", "density_source", "source_hash"]

_UNARY = ("sin", "cos", "tan", "exp", "log", "sqrt", "abs", "sinh", "cosh",
          "tanh")
_BINARY = ("pow", "atan2", "min", "max")


class Unsupported(Exception):
    """An expression node the generated kernels cannot evaluate."""


def _literal(v):
    return f"T({float(v):.17g})" if float(v) == float(v) \
        and abs(float(v)) != float("inf") else f"T({_nonfinite(v)})"


def _nonfinite(v):
    v = float(v)
    if v != v:
        return "NAN"
    return "INFINITY" if v > 0 else "-INFINITY"


def _fold(expr):
    """The float value of a subtree that reads no leaf but pi, else
    None."""
    if expr.leaves() - {"pi"}:
        return None
    if expr.kind == "pindex" or (expr.kind == "call" and
                                 expr.value not in _UNARY + _BINARY
                                 + ("mean",)):
        return None
    v = expr.evaluate(lambda leaf: (_ for _ in ()).throw(
        Unsupported(f"leaf {leaf!r}")))
    return float(v)


def inline(expr, fm, location="ip", stack=frozenset()):
    """The expression with every named function of the FunctionManager
    substituted by its own expression (recursively)."""
    if expr.kind == "leaf" and fm is not None and fm._is_function(
            expr.value):
        if expr.value in stack:
            raise ValueError(f"cyclic function definition involving "
                             f"{expr.value!r}")
        return inline(fm._lookup(expr.value, location), fm, location,
                      stack | {expr.value})
    if expr.args:
        return Expr(expr.kind, expr.value,
                    tuple(inline(a, fm, location, stack) for a in expr.args))
    return expr


def expr_code(expr, leaf_code):
    """The C++ expression of an inlined Expr; leaf_code(name) gives the
    code of each leaf (raising Unsupported where there is none)."""
    folded = _fold(expr)
    if folded is not None:
        return _literal(folded)
    k = expr.kind
    if k == "num":
        return _literal(expr.value)
    if k == "leaf":
        return leaf_code(expr.value)
    if k == "pindex":
        raise Unsupported(f"indexed parameter {expr.value[0]}"
                          f"({expr.value[1]})")
    args = [expr_code(a, leaf_code) for a in expr.args]
    if k == "neg":
        return f"(-{args[0]})"
    if k == "call":
        if expr.value in _UNARY:
            return f"ad_{expr.value}({args[0]})"
        if expr.value in _BINARY:
            return f"ad_{expr.value}({args[0]}, {args[1]})"
        if expr.value == "mean":
            return f"(T(0.5) * ({args[0]} + {args[1]}))"
        raise Unsupported(f"function {expr.value!r}")
    if k == "binop":
        op = expr.value
        if op in "+-*/":
            return f"({args[0]} {op} {args[1]})"
        if op == "^":
            return f"ad_pow({args[0]}, {args[1]})"
        if op in "<>":
            return f"ad_{'lt' if op == '<' else 'gt'}({args[0]}, {args[1]})"
    raise Unsupported(f"node {k!r} {expr.value!r}")


def leaf_coder(variables, params, dim=2):
    """leaf_code for the kernel's density in `dim` dimensions:
    coordinates (x, y[, z]), t, the scalar parameters (sc[1 + 2 + i]:
    after t, beta, T_ambient) and the variables' states u[i]."""
    var_idx = {v: i for i, v in enumerate(variables)}
    par_idx = {p: i for i, p in enumerate(params)}

    def code(leaf):
        if leaf in ("x", "y", "z")[:dim]:
            return leaf
        if leaf == "t":
            return "t"
        if leaf in par_idx:
            return f"T(a.sc[{3 + par_idx[leaf]}])"
        if leaf in var_idx:
            return f"u[{var_idx[leaf]}]"
        raise Unsupported(f"leaf {leaf!r}")
    return code


def _module_code(mi, kind, names, coef, var_idx, nv, buoy_var, dim):
    """The density call of module mi into `m{mi}` and the copies of its
    outputs into `out`: kind is "ns", "thermal" or "cdr", names the
    module's variables, coef its coefficient roles' generated values,
    buoy_var the temperature of the Boussinesq term or None, dim the
    deck's dimension."""
    lines = []
    if kind == "ns":
        n = dim + 1
        i = [var_idx[v] for v in ("ux", "uy", "uz")[:dim] + ("pr",)]

        def row(name):
            return ", ".join(f"{name}[{j}]" for j in i)
        lines.append(f"    S m{mi}[{n * n}];")
        lines.append("    {")
        lines.append(f"      S un[{n}] = {{{row('u')}}};")
        lines.append(f"      S udn[{n}] = {{{row('ud')}}};")
        lines.append(f"      S gn[{n}][{dim}] = {{" + ", ".join(
            "{" + ", ".join(f"g[{j}][{d}]" for d in range(dim)) + "}"
            for j in i) + "};")
        lines.append(f"      const C src[{dim}] = {{" + ", ".join(
            f"lift<C>({c})" for c in coef["src"]) + "};")
        if buoy_var is None:
            lines.append(f"      ns_density<TR, {dim}, S, C>(un, udn, gn, "
                         f"lift<C>({coef['rho']}), lift<C>({coef['visc']}), "
                         f"src, T(a.h), T(a.tau_dt2), a.pspg, a.supg, "
                         f"m{mi});")
        else:
            lines.append(f"      const S buoy = lift<S>(({coef['rho']} * "
                         f"T(a.sc[1])) * (u[{var_idx[buoy_var]}] - "
                         f"T(a.sc[2])));")
            lines.append(f"      ns_density<TR, {dim}, S, C, true>(un, udn, "
                         f"gn, lift<C>({coef['rho']}), "
                         f"lift<C>({coef['visc']}), src, T(a.h), "
                         f"T(a.tau_dt2), a.pspg, a.supg, m{mi}, buoy);")
        lines.append("    }")
        outs = [(i[v], v) for v in range(n)]
        fl = [(i[v], d, n + dim * v + d) for v in range(n)
              for d in range(dim)]
    else:
        (v,) = names
        j = var_idx[v]
        lines.append(f"    S m{mi}[{1 + dim}];")
        b = coef["b"]
        adv = "true" if b else "false"
        # 2D and 3D have functions of their own (scalar_density.cuh says
        # why)
        bs = ", ".join(tuple(b) if b else ("T(0)",) * dim)
        fn = "" if dim == 2 else "_3d"
        if kind == "thermal":
            lines.append(f"    thermal_density{fn}<{adv}, S>(u[{j}], "
                         f"ud[{j}], g[{j}], {coef['rho']}, {coef['cp']}, "
                         f"{coef['f']}, {coef['kappa']}, {bs}, m{mi});")
        else:
            lines.append(f"    cdr_density{fn}<S>(u[{j}], ud[{j}], g[{j}], "
                         f"{coef['diff']}, {coef['rho']}, {coef['cp']}, "
                         f"{coef['reaction']}, {coef['f']}, {bs}, "
                         f"m{mi});")
        outs = [(j, 0)]
        fl = [(j, d, 1 + d) for d in range(dim)]
    assign = [f"    out[{vi}] = m{mi}[{k}];" for vi, k in outs]
    assign += [f"    out[{nv} + {vi} * {dim} + {d}] = m{mi}[{k}];"
               for vi, d, k in fl]
    return lines + assign


def density_struct(modules, variables, params, fm, dim=2):
    """The C++ struct `GenDensity` of one module set in `dim` dimensions:
    its static `eval<TR, S>` takes the state, its time derivative and
    gradient g[v][d], the qp's dim coordinates and the kernel's argument
    struct (any type with the deck's scalars sc, h, tau_dt2, pspg, supg:
    set_node.cuh's SetArgs or the engine's ElemArgs), evaluates the deck's
    coefficients and sums the modules' densities (ns_density.cuh,
    scalar_density.cuh) into the kernel's outputs [S_v for v] + [F_v,d
    for v for d]. `modules`: the physics modules in the deck's order;
    `variables`: the variable names in the kernel's order; `params`: the
    scalar parameter names in sc order. Raises Unsupported where a
    coefficient has no C++ form."""
    nv = len(variables)
    var_idx = {v: i for i, v in enumerate(variables)}
    code = leaf_coder(variables, params, dim)
    body, decl = [], []
    # C, the NS coefficients' type: S where one reads the state
    coef_type = "T"

    def coef(name):
        expr = inline(fm._lookup(name, "ip"), fm)
        k = len(decl)
        decl.append(f"    const auto k{k} = {expr_code(expr, code)};"
                    f"  // {name}")
        return f"k{k}", bool(expr.leaves() & set(variables))

    for mi, m in enumerate(modules):
        roles = dict(m.kernel_coefficients())
        kind = roles.pop("kind")
        out = {}
        for role, fname in roles.items():
            if isinstance(fname, tuple):
                vals = [coef(n) for n in fname]
                out[role] = tuple(v for v, _r in vals)
                state = any(r for _v, r in vals)
            else:
                out[role], state = coef(fname)
            if kind == "ns" and state:
                coef_type = "S"
        names = [v for v, _s, _o in m.variables()]
        buoy = "e" if kind == "ns" and "e" in var_idx else None
        body += _module_code(mi, kind, names, out, var_idx, nv, buoy, dim)
    xyz = ("x", "y", "z")[:dim]
    return "\n".join([
        "struct GenDensity {",
        "  template <bool TR, typename S, typename A>",
        "  __device__ __forceinline__ static void eval(",
        f"      const S u[{nv}], const S ud[{nv}], const S g[{nv}][{dim}],",
        "      " + ", ".join(f"typename Passive<S>::type {c}"
                             for c in xyz) + ",",
        f"      const A& a, S out[{(1 + dim) * nv}]) {{",
        "    using T = typename Passive<S>::type;",
        f"    using C = {coef_type};",
        "    const T t = T(a.sc[0]);",
        "    " + " ".join(f"(void){c};" for c in xyz)
        + " (void)t; (void)ud;",
        *decl,
        *body,
        "  }",
        "};",
    ])


def density_source(modules, variables, params, fm, dim=2, nc=4):
    """The generated translation unit of one module set: on 2D p1 quads
    (dim 2, nc 4) the set_node.cuh kernel template (set_node_full), on 3D
    hex (dim 3, nc 8) and 2D p2 quads (dim 2, nc 9) the set_elem.cuh one
    (set_elem_full), completed with the deck's `density_struct` and
    their entry points."""
    node = (dim, nc) == (2, 4)
    if not node and (dim, nc) not in ((3, 8), (2, 9)):
        raise Unsupported(f"no module-set kernel for dim {dim}, nc {nc}")
    head = ["// Generated by mrhyde_tpu_torch/functions/codegen.py: the qp"]
    if node:
        head += ["// density of one module set for the node-scatter kernel",
                 "// set_node_full (ops/csrc/set_node.cuh). Do not edit."]
        defs = [f"#define SET_NV {len(variables)}",
                '#include "set_node.cuh"']
        entry = "SET_NODE_ENTRY_POINTS(GenDensity)"
    else:
        head += ["// density of one module set for the element-tile kernel",
                 "// set_elem_full (ops/csrc/set_elem.cuh). Do not edit."]
        defs = [f"#define SET_NV {len(variables)}",
                f"#define SET_DIM {dim}", f"#define SET_NC {nc}",
                '#include "set_elem.cuh"']
        entry = "SET_ELEM_ENTRY_POINTS(GenDensity)"
    return "\n".join(head + [
        f"// modules: {', '.join(m.name for m in modules)}; variables: "
        f"{', '.join(variables)}; parameters: {', '.join(params) or '-'}",
        "",
        *defs,
        "",
        "namespace {",
        "",
        density_struct(modules, variables, params, fm, dim),
        "",
        "}  // namespace",
        "",
        entry,
        "",
    ])


def source_hash(text):
    """The name of a generated source: the sha256 of its text."""
    return hashlib.sha256(text.encode()).hexdigest()[:24]

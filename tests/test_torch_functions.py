"""The port's expression DSL (mrhyde_tpu_torch/functions) against the
JAX evaluator: every function and operator of the op tables, the
comparisons, parameter indexing, and the Python-float rule for
expressions that read no array leaf.

Tolerance 1e-14 (relative to max(1, |value|)): both sides evaluate the
same AST in f64 with the same elementary functions; only the last bit
of a libm call may differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhyde_tpu.functions.manager import FunctionManager as JaxFM
from mrhyde_tpu.functions.parser import parse_expression as jax_parse
from mrhyde_tpu_torch.functions.manager import FunctionManager
from mrhyde_tpu_torch.functions.parser import parse_expression

torch.set_num_threads(1)

TOL = 1e-14

EXPRS = [
    "sin(a)", "cos(a)", "tan(a)", "exp(a)", "log(b)", "sqrt(b)",
    "abs(a)", "sinh(a)", "cosh(a)", "tanh(a)",
    "emax(a)", "emin(a)", "emean(a)",
    "min(a, b)", "max(a, b)", "pow(b, a)", "atan2(a, b)", "mean(a, b)",
    "a + b", "a - b", "a * b", "a / b", "b ^ a", "-a", "+a",
    "a < b", "a > b", "(a < 0.1) * b + (a > 0.1) * a",
    "p(0) * a", "q(1) + a",
    "2*(pi*pi)*sin(2*pi*a)*cos(b) - 3.5e-1",
    "min(a, 0.2) + max(0.3, b)",
]


def _inputs():
    rng = np.random.RandomState(7)
    a = rng.uniform(-1.0, 1.0, (5, 4))
    b = rng.uniform(0.5, 2.0, (5, 4))
    return {"a": a, "b": b, "p": 1.75, "q": np.array([0.5, -2.0, 3.0])}


def _eval_both(expr):
    vals = _inputs()
    jv = {k: jnp.asarray(v) for k, v in vals.items()}
    tv = {k: torch.as_tensor(v) for k, v in vals.items()}
    ref = jax_parse(expr).evaluate(jv.__getitem__)
    out = parse_expression(expr).evaluate(tv.__getitem__)
    return np.asarray(ref), out


@pytest.mark.parametrize("expr", EXPRS)
def test_op_matches_jax(expr):
    ref, out = _eval_both(expr)
    assert isinstance(out, torch.Tensor)
    out = out.numpy()
    assert out.shape == ref.shape
    assert out.dtype == np.float64
    scale = max(1.0, float(np.max(np.abs(ref))))
    assert float(np.max(np.abs(out - ref))) <= TOL * scale


@pytest.mark.parametrize("expr", [
    "2*(pi*pi) + sin(1.0)", "exp(0.5) / 3", "min(2.0, 3.0) ^ 2",
    "(1.0 < 2.0) + (3.0 > 4.0)", "-pow(2.0, 0.5) + atan2(1.0, 2.0)",
    "sqrt(-1.0)"])
def test_scalar_expression_stays_python_float(expr):
    """No array leaf: a Python float (the fused path classifies a row as
    element-independent by that), equal to JAX's 0-d value."""
    out = parse_expression(expr).evaluate(lambda leaf: None)
    ref = float(np.asarray(jax_parse(expr).evaluate(lambda leaf: None)))
    assert type(out) is float
    if np.isnan(ref):
        assert np.isnan(out)
    else:
        assert out == pytest.approx(ref, rel=TOL, abs=TOL)


def test_function_manager_resolves_named_functions():
    """Named functions resolve through each other; terminal_leaves sees
    through them."""
    class Ctx:
        def __init__(self, x):
            self.x = x

        def resolve(self, leaf):
            if leaf == "x":
                return self.x
            raise KeyError(leaf)

    x = np.linspace(0.0, 1.0, 7)
    fms = (JaxFM(), FunctionManager())
    for fm in fms:
        fm.add_function("k", "1 + 0.5*g")
        fm.add_function("g", "x*x + pi")
    ref = np.asarray(fms[0].evaluate("k", Ctx(jnp.asarray(x))))
    out = fms[1].evaluate("k", Ctx(torch.as_tensor(x))).numpy()
    assert float(np.max(np.abs(out - ref))) <= TOL * 3
    assert fms[1].terminal_leaves("k") == {"x", "pi"}

"""Every f32 contraction on the render paths states full f32 precision.

A backend's default matmul precision may round f32 operands (TF32 on
recent NVIDIA GPUs keeps ~3 decimal digits), and the tracers position
collisions at km scale to sub-metre accuracy. So every ``dot_general``
with an f32 operand in the c1, c4 and c5 programs must carry
``Precision.HIGHEST``. The one-hot hi/lo-bf16 fetches pass bf16 operands
with f32 accumulation on purpose and are exempt.

The programs are traced (not compiled) from ``bench.py``'s scenes through
the experiments' own render dispatch, once with each table-lookup form
(gathers, and the dense form the GPU may take).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def f32_dots_without_highest(jaxpr):
    """(n_f32_dots, offending eqns) over a jaxpr and all its sub-jaxprs."""
    n, bad = 0, []
    stack = [jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr]
    while stack:
        jx = stack.pop()
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                dtypes = {v.aval.dtype for v in eqn.invars}
                if jnp.dtype(jnp.float32) in dtypes:
                    n += 1
                    prec = eqn.params.get("precision")
                    if prec is None or any(q != HIGHEST for q in prec):
                        bad.append(eqn)
            for v in eqn.params.values():
                stack.extend(_sub_jaxprs(v))
    return n, bad


def _drop_spp(raw):
    return {k: v for k, v in raw.items() if k != "spp"}


def _render_jaxpr(key):
    """Jaxpr of one bench config's render dispatch (small spp)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import bench
    import eradiate_tpu as ert

    _, make_exp, _, mode = next(c for c in bench.CONFIGS if c[0] == key)
    ert.set_mode(mode)
    exp = make_exp()
    exp.init()
    m = exp.measures[0]
    ctx = exp.spectral_context(m)
    if hasattr(exp, "compile_canopy_scene"):
        scene, sensor, config, lp, leaves, tris, tp = (
            exp.compile_canopy_scene(m, ctx)
        )
        return jax.make_jaxpr(
            lambda sc, se, lv: _drop_spp(exp._render_canopy_raw(
                sc, lp, lv, se, config, 64, 0, None, tris, tp
            ))
        )(scene, sensor, leaves)
    scene, sensor, config = exp.compile_scene(m, ctx)
    return jax.make_jaxpr(
        lambda sc, se: _drop_spp(
            exp._render_one(sc, se, config, 64, 0, mesh=None)
        )
    )(scene, sensor)


@pytest.mark.parametrize("dense", [False, True], ids=["gather", "dense"])
@pytest.mark.parametrize(
    "key",
    ["c1_rayleigh_lambert", "c4_spherical_hapke_sza75",
     "c5_canopy_atm_polarized"],
)
def test_render_program_f32_dots_are_highest(key, dense, monkeypatch):
    import eradiate_tpu.ops.medium as med

    monkeypatch.setattr(med, "_dense_lookup", lambda: dense)
    n, bad = f32_dots_without_highest(_render_jaxpr(key))
    assert not bad, [str(e)[:200] for e in bad]
    if key == "c5_canopy_atm_polarized":
        assert n > 0  # the check saw the Mueller-chain contractions


def test_sun_tau_table_build_is_highest():
    """c4's scene compile contracts the slant-path tensor with the
    extinction table."""
    from eradiate_tpu.ops.spherical import (
        sun_mu_grid_warped,
        sun_tau_table_grid,
    )

    radii = jnp.linspace(6378.0, 6498.0, 41)
    sigma = jnp.full((2, 40), 0.01)
    mu = jnp.asarray(sun_mu_grid_warped(16)[0], jnp.float32)
    r0 = jnp.linspace(6378.0, 6498.0, 8)
    n, bad = f32_dots_without_highest(jax.make_jaxpr(
        lambda s: sun_tau_table_grid(s, radii, r0, mu, r_ground=0.0)
    )(sigma))
    assert n > 0 and not bad


def test_checker_flags_default_precision():
    """The walker finds a default-precision f32 dot inside a loop."""
    def f(a):
        return jax.lax.fori_loop(0, 2, lambda i, x: x @ a, a)

    n, bad = f32_dots_without_highest(
        jax.make_jaxpr(f)(np.eye(3, dtype=np.float32))
    )
    assert n == 1 and len(bad) == 1

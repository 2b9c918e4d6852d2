"""Smooth saturation / scaling functions, vectorized elementwise.

Behavioral parity targets (semantics, not code) in the reference:
  - quadratic_saturation            src/Utilities/SmoothingFunctions.f90:275-324
  - quadratic_saturation_derivative src/Utilities/SmoothingFunctions.f90:364-406
  - sq_saturation (cubic S-curve)   src/Utilities/SmoothingFunctions.f90 sQSaturation
  - s_cubic_linear                  src/Utilities/SmoothingFunctions.f90:45-70

All functions are elementwise jnp expressions (``jnp.where`` ladders instead
of branches) so they fuse into the surrounding assembly kernels.
"""

import jax.numpy as jnp

from ..constants import DEM6, DONE, DZERO, DHALF, DPREC


def quadratic_saturation(top, bot, x, eps=DEM6):
    """Quadratic-smoothed saturation in [0, 1] for head ``x`` in cell (top, bot).

    Linear ramp between bot and top with quadratic smoothing of width ``eps``
    (fraction of thickness) at both ends.
    """
    b = top - bot
    # br: raw saturated fraction, clamped to [0, 1]
    safe_b = jnp.where(b > DZERO, b, DONE)
    br = jnp.clip((x - bot) / safe_b, DZERO, DONE)
    av = DONE / (DONE - eps)
    bri = DONE - br
    y = jnp.where(
        br < eps,
        av * DHALF * (br * br) / eps,
        jnp.where(
            br < (DONE - eps),
            av * br + DHALF * (DONE - av),
            jnp.where(br < DONE, DONE - (av * DHALF * (bri * bri)) / eps, DONE),
        ),
    )
    # degenerate zero-thickness cell: step function
    y_step = jnp.where(x < bot, DZERO, DONE)
    return jnp.where(b > DZERO, y, y_step)


def quadratic_saturation_derivative(top, bot, x, eps=DEM6):
    """d(quadratic_saturation)/dx."""
    b = top - bot
    safe_b = jnp.where(b != DZERO, b, DONE)
    br = jnp.clip((x - bot) / safe_b, DZERO, DONE)
    av = DONE / (DONE - eps)
    bri = DONE - br
    y = jnp.where(
        br < eps,
        av * br / eps,
        jnp.where(
            br < (DONE - eps),
            av,
            jnp.where(br < DONE, av * bri / eps, DZERO),
        ),
    )
    return y / safe_b


def sq_saturation(top, bot, x, c1=-2.0, c2=3.0):
    """Cubic S-curve saturation (reference sQSaturation): 0 at bot, 1 at top.

    Used by WEL auto-flow-reduce and other package smoothing.
    """
    b = top - bot
    safe_b = jnp.where(b != DZERO, b, DONE)
    s = jnp.clip((x - bot) / safe_b, DZERO, DONE)
    return c1 * s**3 + c2 * s**2


def sq_saturation_derivative(top, bot, x, c1=-6.0, c2=6.0):
    """Derivative of the cubic S-curve saturation."""
    b = top - bot
    safe_b = jnp.where(b != DZERO, b, DONE)
    s = jnp.clip((x - bot) / safe_b, DZERO, DONE)
    return (c1 * s**2 + c2 * s) / safe_b


def s_cubic_linear(x, srange):
    """Cubic-to-linear smoothing: y=0,dy/dx=0 at x=0; y=1,dy/dx→1 at x=range.

    Returns (y, dydx). Used for DRN drain-discharge scaling.
    """
    s = jnp.maximum(srange, DPREC)
    xs = jnp.clip(x / s, DZERO, None)
    y = jnp.where(xs < DONE, -(xs**3) + 2.0 * xs**2, DONE)
    dydx = jnp.where(xs < DONE, -3.0 * xs**2 + 4.0 * xs, DZERO)
    y = jnp.where(xs <= DZERO, DZERO, y)
    dydx = jnp.where(xs <= DZERO, DZERO, dydx)
    return y, dydx

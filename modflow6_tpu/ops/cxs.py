"""N-point cross-section hydraulics (station/height tables).

Behavioral parity target: src/Model/ModelUtilities/SwfCxsUtils.f90 —
``get_wetted_station`` (wetted sub-segment endpoints),
``get_cross_section_areas``, ``get_wetted_perimeters`` and the composite
conveyance sum of ``get_composite_conveyance``:

    C(d) = Σ_seg a_seg / (rf_seg · rough) · (a_seg / p_seg)^(2/3)

so that Manning flow is Q = C(d)·√S.  Shared by SFR reaches
(gwf-sfr.f90 cross-section option) and SWF/CHF CXS packages
(swf-cxs.f90 get_conveyance).

Design: all segments of all reaches evaluate in parallel as dense
[n_reach, n_pts-1] arrays; ragged sections are padded by repeating the
last station (zero-length segments contribute nothing).  Derivatives for
Newton fills come from numerical perturbation like the reference's
surface-water kernels.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..constants import DZERO

DTWOTHIRDS = 2.0 / 3.0


def segment_wetted(stations, heights, d):
    """Per-segment wetted (area, perimeter) at depth ``d``.

    stations/heights: f64[..., P]; d: f64[...] (broadcast against leading
    dims).  Returns (area[..., P-1], perim[..., P-1]).
    """
    d = jnp.asarray(d)[..., None]
    x0, x1 = stations[..., :-1], stations[..., 1:]
    d0, d1 = heights[..., :-1], heights[..., 1:]
    dmin = jnp.minimum(d0, d1)
    dmax = jnp.maximum(d0, d1)
    dlen_full = d1 - d0
    slope = jnp.where(dlen_full != 0.0, (x1 - x0)
                      / jnp.where(dlen_full != 0.0, dlen_full, 1.0), 0.0)
    xt = x0 + slope * (d - d0)
    # wetted sub-segment endpoints (get_wetted_station)
    mid = (d > dmin) & (d < dmax)
    x0w = jnp.where(d <= dmin, x0, jnp.where(mid & (d0 > d1), xt, x0))
    x1w = jnp.where(d <= dmin, x0, jnp.where(mid & (d0 <= d1), xt, x1))
    xlen = x1w - x0w
    # area (get_cross_section_areas)
    a_above = jnp.where(d > dmax, xlen * (d - dmax), DZERO)
    tri = jnp.where(d < dmax, 0.5 * (d - dmin) * xlen,
                    0.5 * (dmax - dmin) * xlen)
    a_below = jnp.where((dmax != dmin) & (d > dmin), tri, DZERO)
    area = jnp.where(xlen > DZERO, a_above + a_below, DZERO)
    # perimeter (get_wetted_perimeters); vertical walls (xlen==0) count
    dlen_wet = jnp.where(d > dmax, dmax - dmin, d - dmin)
    dlen_wall = jnp.where(d > dmin, jnp.minimum(d, dmax) - dmin, DZERO)
    dlen = jnp.where(xlen > DZERO, dlen_wet, dlen_wall)
    perim = jnp.sqrt(xlen * xlen + dlen * dlen)
    return area, perim


def conveyance(stations, heights, rough_frac, rough, d, rect_mask=None):
    """Conveyance C(d).

    Composite sum over segments (get_composite_conveyance); sections
    flagged rectangular in ``rect_mask`` (4 points with two vertical
    walls, SwfCxsUtils is_rectangular) instead lump total area/perimeter
    into one Manning evaluation (get_rectangular_conveyance) — the two
    differ because the composite treats each wall as its own zero-area
    conveyance element.

    stations/heights f64[..., P]; rough_frac f64[..., P-1] per-segment
    Manning's-n multipliers; rough f64[...] base roughness; d f64[...].
    """
    area, perim = segment_wetted(stations, heights, d)
    rc = rough_frac * rough[..., None]
    rh = jnp.where(perim > DZERO, area / jnp.where(perim > DZERO, perim,
                                                   1.0), DZERO)
    cn = jnp.where(perim > DZERO, area / rc * rh ** DTWOTHIRDS, DZERO)
    c_comp = cn.sum(axis=-1)
    if rect_mask is None:
        return c_comp
    a_tot = area.sum(axis=-1)
    p_tot = perim.sum(axis=-1)
    ravg = rough * rough_frac[..., 0]
    c_rect = jnp.where(
        p_tot > DZERO,
        a_tot / ravg * (a_tot / jnp.where(p_tot > DZERO, p_tot, 1.0))
        ** DTWOTHIRDS, DZERO)
    return jnp.where(rect_mask, c_rect, c_comp)


def wetted_area(stations, heights, d):
    """Total wetted area A(d)."""
    area, _ = segment_wetted(stations, heights, d)
    return area.sum(axis=-1)


def pack_sections(sections):
    """Host-side: pad a list of (station, height, rough_frac) n-point
    sections to one dense table.  Returns (stations[R,P], heights[R,P],
    rough_frac[R,P-1], rect_mask[R]) numpy arrays; padding repeats the
    last station (zero-length dry segments)."""
    P = max(max(len(s[0]) for s in sections), 4)
    R = len(sections)
    st = np.zeros((R, P))
    ht = np.zeros((R, P))
    rf = np.ones((R, P - 1))
    rect = np.zeros(R, bool)
    for i, sec in enumerate(sections):
        x = np.asarray(sec[0], np.float64)
        h = np.asarray(sec[1], np.float64)
        n = x.shape[0]
        st[i, :n] = x
        st[i, n:] = x[-1]
        ht[i, :n] = h
        ht[i, n:] = h[-1]
        if len(sec) > 2 and sec[2] is not None:
            r = np.asarray(sec[2], np.float64)
            rf[i, :n - 1] = r
            rf[i, n - 1:] = r[-1]
        rect[i] = n == 4 and x[0] == x[1] and x[2] == x[3]
    return st, ht, rf, rect

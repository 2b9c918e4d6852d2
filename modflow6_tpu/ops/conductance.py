"""Inter-cell conductance math, vectorized over connections.

Behavioral parity targets in the reference (semantics, not code):
  - hcond / convertible_upstream / convertible_standard
      src/Model/ModelUtilities/GwfConductanceUtils.f90:43-145
  - vcond      GwfConductanceUtils.f90:149-222
  - condmean   GwfConductanceUtils.f90:226-284
  - logmean    GwfConductanceUtils.f90:290-309
  - thksatnm / staggered_thkfrac  GwfConductanceUtils.f90:313-393

Every function operates elementwise on arrays of per-connection quantities
(one entry per symmetric half-connection), so the whole NPF conductance
recalculation is a single fused elementwise pass instead of the reference's
per-connection scalar loop.

Averaging method (``icellavg``) and formulation flags are *static* Python
ints — they select the traced expression at compile time.
"""

import jax.numpy as jnp

from ..constants import (
    C3D_STAGGERED,
    CCOND_AMTHMK,
    CCOND_AMTLMK,
    CCOND_HMEAN,
    CCOND_LMEAN,
    DHALF,
    DLNHIGH,
    DLNLOW,
    DONE,
    DZERO,
)


def logmean(d1, d2):
    """Logarithmic mean of two positive numbers, arithmetic near ratio 1."""
    safe_d1 = jnp.where(d1 != DZERO, d1, DONE)
    drat = d2 / safe_d1
    use_log = (drat <= DLNLOW) | (drat >= DLNHIGH)
    safe_log = jnp.log(jnp.where(use_log & (drat > DZERO), drat, DONE))
    safe_log = jnp.where(safe_log != DZERO, safe_log, DONE)
    return jnp.where(use_log, (d2 - d1) / safe_log, DHALF * (d1 + d2))


def condmean(k1, k2, thick1, thick2, cl1, cl2, width, iavgmeth):
    """Mean conductance between two cells for the given averaging method."""
    t1 = k1 * thick1
    t2 = k2 * thick2
    if iavgmeth == CCOND_HMEAN:
        denom = t1 * cl2 + t2 * cl1
        safe = jnp.where(denom != DZERO, denom, DONE)
        return jnp.where(t1 * t2 > DZERO, width * t1 * t2 / safe, DZERO)
    elif iavgmeth == CCOND_LMEAN:
        tmean = jnp.where(t1 * t2 > DZERO, logmean(t1, t2), DZERO)
        return tmean * width / (cl1 + cl2)
    elif iavgmeth == CCOND_AMTLMK:
        kmean = jnp.where(k1 * k2 > DZERO, logmean(k1, k2), DZERO)
        return kmean * DHALF * (thick1 + thick2) * width / (cl1 + cl2)
    elif iavgmeth == CCOND_AMTHMK:
        denom = k1 * cl2 + k2 * cl1
        safe = jnp.where(denom > DZERO, denom, DONE)
        kmean = jnp.where(denom > DZERO, k1 * k2 / safe, DZERO)
        return kmean * DHALF * (thick1 + thick2) * width
    else:
        raise ValueError(f"unknown cell averaging method {iavgmeth}")


def staggered_thkfrac(top, bot, sat, topc, botc):
    """Wetted thickness of a cell limited to the overlap (sill) with its neighbor."""
    sill_top = jnp.minimum(top, topc)
    sill_bot = jnp.maximum(bot, botc)
    tp = bot + sat * (top - bot)
    return jnp.maximum(jnp.minimum(tp, sill_top) - sill_bot, DZERO)


def hcond(
    ibdn,
    ibdm,
    ictn,
    ictm,
    iupstream,
    ihc,
    icellavg,
    condsat,
    hn,
    hm,
    satn,
    satm,
    hkn,
    hkm,
    topn,
    topm,
    botn,
    botm,
    cln,
    clm,
    fawidth,
):
    """Horizontal conductance between connected cell pairs (vectorized).

    ``iupstream`` and ``icellavg`` are static ints; everything else may be
    arrays over connections.
    """
    if iupstream == 1:
        sat_up = jnp.where(hn > hm, satn, satm)
        cond_conv = sat_up * condsat
    else:
        is_stag = ihc == C3D_STAGGERED
        thksatn = jnp.where(
            is_stag,
            staggered_thkfrac(topn, botn, satn, topm, botm),
            satn * (topn - botn),
        )
        thksatm = jnp.where(
            is_stag,
            staggered_thkfrac(topm, botm, satm, topn, botn),
            satm * (topm - botm),
        )
        cond_conv = condmean(hkn, hkm, thksatn, thksatm, cln, clm, fawidth, icellavg)

    both_nonconvertible = (ictn == 0) & (ictm == 0)
    cond = jnp.where(both_nonconvertible, condsat, cond_conv)
    inactive = (ibdn == 0) | (ibdm == 0)
    return jnp.where(inactive, DZERO, cond)


def vcond(
    ibdn,
    ibdm,
    ictn,
    ictm,
    ivarcv,
    idewatcv,
    condsat,
    hn,
    hm,
    vkn,
    vkm,
    satn,
    satm,
    topn,
    topm,
    botn,
    botm,
    flowarea,
):
    """Vertical conductance between vertically connected cell pairs.

    ``ivarcv``/``idewatcv`` are static ints (NPF VARIABLECV / DEWATERED options).
    Cell n is the upper cell of each pair.
    """
    inactive = (ibdn == 0) | (ibdm == 0)
    if ivarcv == 0:
        return jnp.where(inactive, DZERO, condsat)

    # variable-CV path: recompute from wetted thicknesses when not saturated
    if idewatcv == 0:
        # no dewatered correction: underlying cell treated as fully saturated
        n_is_upper = botn > botm
        satntmp = jnp.where(n_is_upper, satn, DONE)
        satmtmp = jnp.where(n_is_upper, DONE, satm)
    else:
        satntmp = satn
        satmtmp = satm
    bovk1 = satntmp * (topn - botn) * DHALF / vkn
    bovk2 = satmtmp * (topm - botm) * DHALF / vkm
    denom = bovk1 + bovk2
    safe = jnp.where(denom != DZERO, denom, DONE)
    cond_recalc = jnp.where(denom != DZERO, flowarea / safe, DZERO)

    both_nonconvertible = (ictn == 0) & (ictm == 0)
    fully_saturated = (hn >= topn) & (hm >= topm)
    cond = jnp.where(both_nonconvertible | fully_saturated, condsat, cond_recalc)
    return jnp.where(inactive, DZERO, cond)


def thksatnm(ibdn, ibdm, ictn, ictm, iupstream, ihc, hn, hm, satn, satm, topn, topm, botn, botm):
    """Wetted interface thickness for a horizontal connection (for spdis/flows)."""
    is_stag = ihc == C3D_STAGGERED

    # both non-convertible
    sill_top = jnp.minimum(topn, topm)
    sill_bot = jnp.maximum(botn, botm)
    thk_stag_conf = jnp.maximum(sill_top - sill_bot, DZERO)
    thk_conf = jnp.where(
        is_stag, thk_stag_conf, DHALF * ((topn - botn) + (topm - botm))
    )

    if iupstream == 1:
        thk_conv = jnp.where(hn > hm, satn * (topn - botn), satm * (topm - botm))
    else:
        thksatn = jnp.where(
            is_stag,
            staggered_thkfrac(topn, botn, satn, topm, botm),
            satn * (topn - botn),
        )
        thksatm = jnp.where(
            is_stag,
            staggered_thkfrac(topm, botm, satm, topn, botn),
            satm * (topm - botm),
        )
        thk_conv = DHALF * (thksatn + thksatm)

    both_nonconvertible = (ictn == 0) & (ictm == 0)
    res = jnp.where(both_nonconvertible, thk_conf, thk_conv)
    inactive = (ibdn == 0) | (ibdm == 0)
    return jnp.where(inactive, DZERO, res)

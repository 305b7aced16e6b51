# Frozen copy of fesom2_tpu_torch/forcing/tides.py, lines 1-267 at git e5ef625,
# with each kernel's dispatch replaced by its plain torch version.
"""Luni-solar equilibrium tidal potential (ref ``src/gen_modules_gpot.F90``,
module mo_tidal: foreph_ini/foreph and the low-precision sun and moon
ephemeris).

The port of ``fesom2_tpu/forcing/tides.py``, in torch.  The ephemeris is a
chain of scalar functions of the step counter, computed in the model's
dtype as the JAX package does (the time since 2000-01-01 in steps,
about -1.8e6 for 1948, cancels badly in float32 there too); the Kepler
equation (ref ``anomaly``) takes a fixed 8 Newton sweeps.  The potential
at the nodes is a formula over [N].
"""
from __future__ import annotations

import numpy as np
import torch

rad = np.pi / 180.0
EEF = 0.69                    # solid-earth loading factor
TWO_PI = 2.0 * np.pi


def _leap(y):
    return 1 if (y % 4 == 0 and y % 100 != 0) or y % 400 == 0 else 0


def foreph_offset(year: int, month: int, dt: float) -> float:
    """Timestep count since 2000-01-01 00:00 at the run start
    (ref foreph_ini/eph :13-49)."""
    jcc = 0
    if year < 2000:
        for y in range(year, 2000):
            jcc -= 365 + _leap(y)
    elif year > 2000:
        for y in range(2000, year):
            jcc += 365 + _leap(y)
    mdays = [31, 28 + _leap(year), 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    moph = sum(mdays[: month - 1])
    return (jcc + moph - 0.5) * round(86400.0 / dt)


def _wrap(x):
    return torch.remainder(x, TWO_PI)


def _frac360(a):
    return 360.0 * (a - torch.floor(a))


def _anomaly(am, ec):
    """Eccentric + true anomaly from the mean anomaly (ref anomaly :
    Kepler equation by Newton, fixed sweeps)."""
    m = am - TWO_PI * torch.floor(am / TWO_PI)
    ae = m
    for _ in range(8):
        d = ae - ec * torch.sin(ae) - m
        ae = ae - d / (1.0 - ec * torch.cos(ae))
    at = 2.0 * torch.atan(torch.sqrt((1.0 + ec) / (1.0 - ec))
                          * torch.tan(ae / 2.0))
    return at, ae


def _eqecl(x, y, ecl, sw):
    """Ecliptic -> equatorial (ref eqecl)."""
    p = torch.atan2(torch.sin(x) * torch.cos(ecl)
                    + torch.tan(y) * torch.sin(ecl) * sw, torch.cos(x))
    p = _wrap(p)
    q = torch.asin(torch.sin(y) * torch.cos(ecl)
                   - torch.cos(y) * torch.sin(ecl) * torch.sin(x) * sw)
    return p, q


def _ephemeris(t):
    """Right ascension/declination/inverse-cube distance of sun and moon at
    julian centuries t since J2000 (ref ephvsop87/sidt2/obliq/sun_n/moon/
    aufb2, fnut=0 branch)."""
    t2, t3 = t * t, t ** 3
    jd = t * 36525.0 + 2451545.0
    sidt = _wrap((280.46061837 + 360.98564736629 * (jd - 2451545.0)
                  + 0.000387933 * t2 - t3 / 38710000.0) * rad)

    # obliquity (no nutation, fnut=0)
    t1 = t + 1.0
    t12, t13 = t1 * t1, t1 ** 3
    c = 46.815 * t1 + 0.0006 * t12 - 0.00181 * t13
    ecl = (23.43929167 - c / 3600.0) * rad

    # ---- sun (ref sun_n) -------------------------------------------------
    l_ = (279.69668 + 0.0003025 * t12 + _frac360(100.0021359 * t1)) * rad
    m1 = (358.47583 - 0.00015 * t12 + 0.0000033 * t13
          + _frac360(99.99736042 * t1)) * rad
    ec = 0.01675104 - 0.0000418 * t1 - 0.000000126 * t12
    at, ae = _anomaly(m1, ec)
    a1 = (153.23 + _frac360(62.55209472 * t1)) * rad
    b1 = (216.57 + _frac360(125.1041894 * t1)) * rad
    c1 = (312.69 + _frac360(91.56766028 * t1)) * rad
    d1 = (350.74 - 0.00144 * t12 + _frac360(1236.853095 * t1)) * rad
    e1 = (231.19 + 20.2 * t1) * rad
    h1 = (353.4 + _frac360(183.1353208 * t1)) * rad
    d2 = (0.00134 * torch.cos(a1) + 0.00154 * torch.cos(b1) + 0.002 * torch.cos(c1)
          + 0.00179 * torch.sin(d1) + 0.00178 * torch.sin(e1)) * rad
    d3 = (0.00000543 * torch.sin(a1) + 0.00001575 * torch.sin(b1)
          + 0.00001627 * torch.sin(c1) + 0.00003076 * torch.cos(d1)
          + 0.00000927 * torch.sin(h1))
    s1 = _wrap(at + l_ - m1 + d2)
    s3 = 1.0000002 * (1.0 - ec * torch.cos(ae)) + d3
    rekts, dekls = _eqecl(s1, torch.zeros_like(s1), ecl, -1.0)

    # ---- moon (ref moon) -------------------------------------------------
    q = t1 * 36525.0
    def mfrac(per):
        v = q / per
        return 360.0 * (v - torch.floor(v))
    m1m = mfrac(27.32158213)
    m2m = mfrac(365.2596407)
    m3m = mfrac(27.55455094)
    m4m = mfrac(29.53058868)
    m5m = mfrac(27.21222039)
    m6m = mfrac(6798.363307)
    ml = 270.434164 + m1m - 0.001133 * t12 + 0.0000019 * t13
    ms = 358.475833 + m2m - 0.00015 * t12 + 0.0000033 * t13
    md = 296.104608 + m3m + 0.009192 * t12 + 0.0000144 * t13
    me = 350.737486 + m4m - 0.001436 * t12 + 0.0000019 * t13
    mf = 11.250889 + m5m - 0.003211 * t12 - 0.0000003 * t13
    na = (259.183275 - m6m + 0.002078 * t12 + 0.0000022 * t13) * rad
    s2m = torch.sin(na)
    a = (51.2 + 20.2 * t1) * rad
    s1m = torch.sin(a)
    b = (346.56 + 132.87 * t1 - 0.0091731 * t12) * rad
    s3m = 0.003964 * torch.sin(b)
    cna = na + (275.05 - 2.3 * t1) * rad
    s4m = torch.sin(cna)
    ml = (ml + 0.000233 * s1m + s3m + 0.001964 * s2m) * rad
    ms = (ms - 0.001778 * s1m) * rad
    md = (md + 0.000817 * s1m + s3m + 0.002541 * s2m) * rad
    mf = (mf + s3m - 0.024691 * s2m - 0.004328 * s4m) * rad
    me = (me + 0.002011 * s1m + s3m + 0.001964 * s2m) * rad
    e = 1.0 - 0.002495 * t1 + 0.00000752 * t12
    e2 = e * e
    sin, cos = torch.sin, torch.cos
    L = (6.28875 * sin(md) + 1.274018 * sin(2 * me - md)
         + 0.658309 * sin(2 * me) + 0.213616 * sin(2 * md)
         - e * 0.185596 * sin(ms) - 0.114336 * sin(2 * mf)
         + 0.058793 * sin(2 * (me - md))
         + 0.057212 * e * sin(2 * me - ms - md) + 0.05332 * sin(2 * me + md)
         + 0.045874 * e * sin(2 * me - ms) + 0.041024 * e * sin(md - ms)
         - 0.034718 * sin(me) - e * 0.030465 * sin(md + ms)
         + 0.015326 * sin(2 * (me - mf)) - 0.012528 * sin(2 * mf + md)
         - 0.01098 * sin(2 * mf - md) + 0.010674 * sin(4 * me - md)
         + 0.010034 * sin(3 * md) + 0.008548 * sin(4 * me - 2 * md)
         - e * 0.00791 * sin(ms - md + 2 * me) - e * 0.006783 * sin(2 * me + ms)
         + 0.005162 * sin(md - me) + e * 0.005 * sin(me + ms)
         + 0.003862 * sin(4 * me) + e * 0.004049 * sin(md - ms + 2 * me)
         + 0.003996 * sin(2 * (md + me)) + 0.003665 * sin(2 * me - 3 * md)
         + e * 0.002695 * sin(2 * md - ms)
         + 0.002602 * sin(md - 2 * (mf + me))
         + e * 0.002396 * sin(2 * (me - md) - ms) - 0.002349 * sin(me + md)
         + e2 * 0.002249 * sin(2 * (me - ms)) - e * 0.002125 * sin(ms + 2 * md)
         - e2 * 0.002079 * sin(2 * ms) + e2 * 0.002059 * sin(2 * (me - ms) - md)
         - 0.001773 * sin(2 * (me - mf) + md) - 0.001595 * sin(2 * (me + mf))
         + e * 0.00122 * sin(4 * me - ms - md) - 0.00111 * sin(2 * (md + mf))
         + 0.000892 * sin(md - 3 * me) - e * 0.000811 * sin(ms + md + 2 * me)
         + e * 0.000761 * sin(4 * me - ms - 2 * md)
         + e2 * 0.000704 * sin(md - 2 * (ms + me))
         + e * 0.000693 * sin(ms - 2 * (md - me))
         + e * 0.000598 * sin(2 * (me - mf) - ms)
         + 0.00055 * sin(md + 4 * me) + 0.000538 * sin(4 * md)
         + e * 0.000521 * sin(4 * me - ms) + 0.000486 * sin(2 * md - me)
         + e2 * 0.000717 * sin(md - 2 * ms))
    mo1 = _wrap(ml + L * rad)
    G = (5.128189 * sin(mf) + 0.280606 * sin(md + mf)
         + 0.277693 * sin(md - mf) + 0.173238 * sin(2 * me - mf)
         + 0.055413 * sin(2 * me + mf - md)
         + 0.046272 * sin(2 * me - mf - md) + 0.032573 * sin(2 * me + mf)
         + 0.017198 * sin(2 * md + mf) + 0.009267 * sin(2 * me - mf + md)
         + 0.008823 * sin(2 * md - mf) + e * 0.008247 * sin(2 * me - ms - mf)
         + 0.004323 * sin(2 * (me + md) - mf) + 0.0042 * sin(2 * me + md + mf)
         + e * 0.003372 * sin(mf - ms - 2 * me)
         + e * 0.002472 * sin(2 * me - md + mf - ms)
         + e * 0.002222 * sin(2 * me + mf - ms)
         + e * 0.002072 * sin(2 * me - md - mf - ms)
         + e * 0.001877 * sin(mf - ms + md) + 0.001828 * sin(4 * me - md - mf)
         - e * 0.001803 * sin(ms + mf) - 0.00175 * sin(3 * mf)
         + e * 0.00157 * sin(md - mf - ms) - 0.001487 * sin(me + mf)
         - e * 0.001481 * sin(mf + ms + md) + e * 0.001417 * sin(mf - ms - md)
         + e * 0.00135 * sin(mf - ms) + 0.00133 * sin(mf - me)
         + 0.001106 * sin(mf + 3 * md) + 0.00102 * sin(4 * me - mf)
         + 0.000833 * sin(mf + 4 * me - md) + 0.000781 * sin(md - 3 * mf)
         + 0.00067 * sin(mf + 3 * me - 2 * md)
         + 0.000606 * sin(2 * me - 3 * mf)
         + 0.000597 * sin(2 * (me + md) - mf)
         + e * 0.000492 * sin(2 * me + md - ms - mf)
         + 0.00045 * sin(2 * (md - me) - mf) + 0.000439 * sin(3 * me - mf)
         + 0.000423 * sin(mf + 2 * (me + md))
         + 0.000422 * sin(2 * me - 3 * md - mf)
         - e * 0.000367 * sin(mf + ms + 2 * me - md)
         - e * 0.000353 * sin(mf + ms + 2 * me) + 0.000331 * sin(mf + 4 * me)
         + e * 0.000317 * sin(2 * me + md - ms + mf)
         + e2 * 0.000306 * sin(2 * (me - ms) - mf)
         - 0.000283 * sin(md + 3 * mf))
    w1 = 0.0004664 * cos(na)
    w2 = 0.0000754 * cos(cna)
    mo2 = G * rad * (1.0 - w1 - w2)
    pm = (0.950724 + 0.051818 * cos(md) + 0.009531 * cos(2 * me - md)
          + 0.007843 * cos(2 * me) + 0.002824 * cos(2 * md)
          + 0.000857 * cos(2 * me + md) + e * 0.000533 * cos(2 * me - ms)
          + e * 0.000401 * cos(2 * me - md - ms) + e * 0.00032 * cos(md - ms)
          - 0.000271 * cos(me) - e * 0.000264 * cos(md + ms)
          - 0.000198 * cos(2 * mf - md) + 0.000173 * cos(3 * md)
          + 0.000167 * cos(4 * me - md) - e * 0.000111 * cos(ms)
          + 0.000103 * cos(4 * me - 2 * md)
          - 0.000084 * cos(2 * md - 2 * me) - e * 0.000083 * cos(2 * me + ms)
          + 0.000079 * cos(2 * me + 2 * md) + 0.000072 * cos(4 * me)
          + e * 0.000064 * cos(2 * me - ms + md)
          - e * 0.000063 * cos(2 * me + ms - md) + e * 0.000041 * cos(ms + me)
          + e * 0.000035 * cos(2 * md - ms) - 0.000033 * cos(3 * md - 2 * me)
          - 0.00003 * cos(md + me) - 0.000029 * cos(2 * (mf - me))
          - e * 0.000029 * cos(2 * md + ms) + e2 * 0.000026 * cos(2 * (me - ms))
          - 0.000023 * cos(2 * (mf - me) + md)
          + e * 0.000019 * cos(4 * me - md - ms)) * rad
    mo3 = 6378.14 / torch.sin(pm)
    rektm, deklm = _eqecl(mo1, mo2, ecl, -1.0)

    # ---- hour angles + inverse-cube distances (ref aufb2) ----------------
    rekts_h = sidt - rekts
    rektm_h = sidt - rektm
    cris3 = (1.0 / s3) ** 3
    crim3 = (384400.0 / mo3) ** 3
    return rekts_h, dekls, cris3, rektm_h, deklm, crim3


def tidal_potential(mmccdt, dt, geo_lon, geo_lat):
    """Equilibrium tidal potential ssh_gp [N] in m^2/s^2 at timestep counter
    ``mmccdt`` since 2000-01-01 (ref foreph :52-100), in the dtype of
    ``geo_lon`` [N] (radians).  ``mmccdt`` is a 0-d tensor of that dtype,
    or a number: then the ephemeris (a chain of some 300 scalar functions)
    runs on the host in that dtype and its six results reach the nodes'
    device as fills, not as copies from host memory, so no step waits on
    the device for them."""
    dtype, dev = geo_lon.dtype, geo_lon.device
    if not isinstance(mmccdt, torch.Tensor):
        mmccdt = torch.full((), float(mmccdt), dtype=dtype)
    rkomp = -4.113e-07            # lunar tidal potential factor
    rkosp = 0.46051 * rkomp       # solar / lunar ratio
    erdrad = 6371000.0
    t = (mmccdt - 1.0) * dt / 86400.0 / 36525.0
    eph = _ephemeris(t)
    if t.device != dev:
        eph = [torch.full((), float(x), dtype=dtype, device=dev) for x in eph]
    rekts, dekls, cris3, rektm, deklm, crim3 = eph

    sidm, codm = torch.sin(deklm), torch.cos(deklm)
    sids, cods = torch.sin(dekls), torch.cos(dekls)
    sidm2, sids2 = torch.sin(2 * deklm), torch.sin(2 * dekls)
    slat, s2lat, clat = (torch.sin(geo_lat), torch.sin(2 * geo_lat),
                         torch.cos(geo_lat))
    hamp = rektm + geo_lon
    hasp = rekts + geo_lon
    third = 1.0 / 3.0
    moon = EEF * erdrad * rkomp * crim3 * (
        3.0 * (slat ** 2 - third) * (sidm ** 2 - third)
        + s2lat * sidm2 * torch.cos(hamp)
        + clat ** 2 * codm ** 2 * torch.cos(2 * hamp))
    sun = erdrad * rkosp * cris3 * (
        3.0 * (slat ** 2 - third) * (sids ** 2 - third)
        + s2lat * sids2 * torch.cos(hasp)
        + clat ** 2 * cods ** 2 * torch.cos(2 * hasp))
    return moon + sun

"""Synthetic decks: SPE1 physics at arbitrary grid sizes, and a wet-gas
condensate strip.

The SPE1 generator is the reference package's (published Odeh 1981
data; only DIMENS and well placement scale); chip_smoke.py runs it on
the SPE10 model-2 grid. The wet-gas deck exercises the PVTG 2-D table.
"""

from __future__ import annotations


def spe1_deck_text(nx: int = 10, ny: int = 10, nz: int = 3,
                   tstep_days: str = "1 2 3 4 5 10 10 15 25 25") -> str:
    n = nx * ny * nz
    nxy = nx * ny

    def layer_vals(vals):
        per = []
        reps = [nz // 3 + (1 if i < nz % 3 else 0) for i in range(3)]
        for v, r in zip(vals, reps):
            if r:
                per.append(f"{nxy * r}*{v}")
        return " ".join(per)

    dz_total = 100.0  # keep column height fixed as nz scales
    dz = dz_total / nz

    return f"""RUNSPEC
TITLE
 SPE1 scaled {nx}x{ny}x{nz}
DIMENS
 {nx} {ny} {nz} /
OIL
GAS
WATER
DISGAS
FIELD
EQLDIMS
 1 100 10 1 1 /
TABDIMS
 1 1 40 40 1 40 /
WELLDIMS
 2 {nz} 1 2 /
START
 1 'JAN' 2015 /
GRID
DX
 {n}*{10000.0 / nx} /
DY
 {n}*{10000.0 / ny} /
DZ
 {n}*{dz} /
TOPS
 {nxy}*8325 /
PORO
 {n}*0.3 /
PERMX
 {layer_vals([500, 50, 200])} /
PERMY
 {layer_vals([500, 50, 200])} /
PERMZ
 {layer_vals([50, 50, 25])} /
PROPS
PVTW
 4014.7 1.029 3.13E-6 0.31 0 /
ROCK
 14.7 3E-6 /
SWOF
 0.12    0      1      0
 1.0     0.00001 0     0 /
SGOF
 0       0      1      0
 0.001   0      1      0
 0.02    0      0.997  0
 0.05    0.005  0.980  0
 0.12    0.025  0.700  0
 0.2     0.075  0.350  0
 0.25    0.125  0.200  0
 0.3     0.190  0.090  0
 0.4     0.410  0.021  0
 0.45    0.60   0.010  0
 0.5     0.72   0.001  0
 0.6     0.87   0.0001 0
 0.7     0.94   0.000  0
 0.85    0.98   0.000  0
 1.0     1.0    0.000  0 /
DENSITY
 49.1 64.79 0.06054 /
PVDG
 14.7     166.666   0.008
 264.7    12.093    0.0096
 514.7    6.274     0.0112
 1014.7   3.197     0.014
 2014.7   1.614     0.0189
 2514.7   1.294     0.0208
 3014.7   1.080     0.0228
 4014.7   0.811     0.0268
 5014.7   0.649     0.0309
 9014.7   0.386     0.047 /
PVTO
 0.001    14.7    1.062     1.04 /
 0.0905   264.7   1.15      0.975 /
 0.18     514.7   1.207     0.91 /
 0.371    1014.7  1.295     0.83 /
 0.636    2014.7  1.435     0.695 /
 0.775    2514.7  1.5       0.641 /
 0.93     3014.7  1.565     0.594 /
 1.270    4014.7  1.695     0.51
          5014.7  1.671     0.549
          9014.7  1.579     0.74 /
 1.618    5014.7  1.827     0.449
          9014.7  1.726     0.605 /
 2.984    9014.7  2.357     0.203 /
/
SOLUTION
EQUIL
 8400 4800 8500 0 8200 0 1 0 0 /
RSVD
 8200 1.270
 8500 1.270 /
SUMMARY
FOPR
FGOR
SCHEDULE
WELSPECS
 'PROD' 'G1' {nx} {ny} 8400 'OIL' /
 'INJ'  'G1' 1  1  8335 'GAS' /
/
COMPDAT
 'PROD' {nx} {ny} {nz} {nz} 'OPEN' 1* 1* 0.5 /
 'INJ'  1  1  1 1 'OPEN' 1* 1* 0.5 /
/
WCONPROD
 'PROD' 'OPEN' 'ORAT' 20000 4* 1000 /
/
WCONINJE
 'INJ' 'GAS' 'OPEN' 'RATE' 100000 1* 9014 /
/
TSTEP
 {tstep_days} /
END
"""


def write_spe1_deck(path: str, nx: int = 10, ny: int = 10, nz: int = 3,
                    **kw) -> str:
    with open(path, "w") as f:
        f.write(spe1_deck_text(nx, ny, nz, **kw))
    return path


# ---------------------------------------------------------------------------
# Wet-gas (PVTG / VAPOIL) condensate strip
# ---------------------------------------------------------------------------

def wetgas_deck_text() -> str:
    """Gas-condensate strip (10x1x1): water + wet gas, no initial oil,
    producing below the dew point (retrograde condensation). Exercises the
    PVTG 2-D table and the Rv primary-variable state."""
    return WETGAS_DECK


WETGAS_DECK = """RUNSPEC
DIMENS
 10 1 1 /
OIL
WATER
GAS
DISGAS
VAPOIL
METRIC
START
 1 'JAN' 2020 /
GRID
DX
 10*30 /
DY
 10*30 /
DZ
 10*10 /
TOPS
 10*2500 /
PORO
 10*0.20 /
PERMX
 10*200 /
PROPS
PVTW
 250 1.02 4.0E-5 0.4 0 /
PVTO
 10  50 1.15 1.0
    300 1.10 1.1 /
 80 250 1.35 0.6
    400 1.30 0.7 /
/
PVTG
-- p(bar)  rv      bg      mu
 50   0.00002 0.025  0.014
      0.0     0.024  0.013 /
 150  0.00008 0.0075 0.016
      0.0     0.0073 0.015 /
 250  0.00020 0.0045 0.020
      0.00010 0.0044 0.019
      0.0     0.0043 0.018 /
/
ROCK
 250 4E-5 /
SWOF
 0.20 0.00  0.90 0
 0.60 0.30  0.20 0
 1.00 1.00  0.0  0 /
SGOF
 0.00 0.00 0.90 0
 0.40 0.30 0.30 0
 0.80 0.85 0.0  0 /
DENSITY
 700 1000 0.9 /
SOLUTION
PRESSURE
 10*250 /
SWAT
 10*0.20 /
SGAS
 10*0.80 /
RS
 10*0 /
SUMMARY
FOPR
SCHEDULE
WELSPECS
 'P1' 'G' 10 1 2505 'GAS' /
/
COMPDAT
 'P1' 10 1 1 1 'OPEN' 1* 1* 0.3 /
/
WCONPROD
 'P1' 'OPEN' 'GRAT' 2* 40000 3* 60 /
/
TSTEP
 2 5 10 20 /
END
"""

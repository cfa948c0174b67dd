"""Unit systems: FIELD / METRIC / LAB deck units -> SI.

The reference gets this from opm-common's UnitSystem; deck quantities are
converted to SI at parse time and back at output time (SURVEY.md §7 stage 1).
All internal computation is SI: Pa, m, s, kg, m^3.
"""

from __future__ import annotations

import dataclasses

# --- fundamental conversion constants (exact where defined exactly) ---
FOOT = 0.3048  # m
INCH = 0.0254  # m
PSI = 6894.75729316836  # Pa
BAR = 1.0e5  # Pa
ATM = 101325.0  # Pa
DAY = 86400.0  # s
HOUR = 3600.0  # s
YEAR = 365.0 * DAY
CP = 1.0e-3  # Pa*s
DARCY = 9.869232667160128e-13  # m^2
MILLIDARCY = DARCY * 1e-3
STB = 0.158987294928  # m^3  (42 US gallons)
MSCF = 1000.0 * FOOT**3  # m^3 (1000 standard cubic feet)
SCF = FOOT**3
LBM = 0.45359237  # kg
LB_PER_FT3 = LBM / FOOT**3  # kg/m^3
GRAVITY = 9.80665  # m/s^2

# Standard conditions (ECL: 60F, 14.696 psia; densities are given at surface
# conditions in the deck so we only need them as labels).
P_STANDARD = ATM
T_STANDARD = 288.706  # K (60 F)


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    """Multiplicative to-SI factors for each deck dimension."""

    name: str
    pressure: float  # -> Pa
    length: float  # -> m
    time: float  # -> s
    density: float  # -> kg/m^3
    liquid_volume: float  # surface liquid volume -> m^3
    gas_volume: float  # surface gas volume -> m^3
    reservoir_volume: float  # reservoir volume -> m^3
    viscosity: float  # -> Pa*s
    permeability: float  # -> m^2
    temperature_offset: float  # additive, deg -> K
    temperature_scale: float
    energy: float = 1.0  # deck energy unit -> J (METRIC kJ, FIELD Btu)

    # ---- derived, frequently used compound factors ----
    @property
    def liquid_rate(self) -> float:  # surface liquid volume / time
        return self.liquid_volume / self.time

    @property
    def gas_rate(self) -> float:
        return self.gas_volume / self.time

    @property
    def reservoir_rate(self) -> float:
        return self.reservoir_volume / self.time

    @property
    def gas_oil_ratio(self) -> float:  # Rs: gas volume / liquid volume
        return self.gas_volume / self.liquid_volume

    @property
    def oil_gas_ratio(self) -> float:  # Rv
        return self.liquid_volume / self.gas_volume

    @property
    def oil_fvf(self) -> float:  # Bo: reservoir volume / surface liquid volume
        return self.reservoir_volume / self.liquid_volume

    @property
    def gas_fvf(self) -> float:  # Bg
        return self.reservoir_volume / self.gas_volume

    @property
    def compressibility(self) -> float:  # 1/pressure
        return 1.0 / self.pressure

    @property
    def transmissibility(self) -> float:
        # ECL deck trans: cp*vol/(day*pressure); SI trans is just m^3
        # (flux = T * mob * dp with mob in 1/(Pa*s)). Deck-specified
        # transmissibility values (TRANX etc.) convert with this factor.
        return self.viscosity * self.reservoir_volume / (self.time * self.pressure)

    @property
    def well_index(self) -> float:
        # CF in COMPDAT: cp*vol/(day*pressure) -> m^3 in SI
        return self.transmissibility

    @property
    def mass(self) -> float:
        # deck mass unit: FIELD lb, METRIC kg (density * volume)
        return self.density * self.length ** 3

    @property
    def polymer_concentration(self) -> float:
        # WPOLYMER/PLYVISC node units: mass / surface liquid volume
        # (FIELD: lb/stb, METRIC: kg/sm3)
        return self.mass / self.liquid_volume


FIELD = UnitSystem(
    name="FIELD",
    pressure=PSI,
    length=FOOT,
    time=DAY,
    density=LB_PER_FT3,
    liquid_volume=STB,
    gas_volume=MSCF,
    reservoir_volume=STB,  # reservoir barrels
    viscosity=CP,
    permeability=MILLIDARCY,
    temperature_offset=255.3722222222222,  # F -> K: (F + 459.67) * 5/9
    temperature_scale=5.0 / 9.0,
    energy=1055.05585262,  # Btu
)

METRIC = UnitSystem(
    name="METRIC",
    pressure=BAR,
    length=1.0,
    time=DAY,
    density=1.0,
    liquid_volume=1.0,
    gas_volume=1.0,
    reservoir_volume=1.0,
    viscosity=CP,
    permeability=MILLIDARCY,
    temperature_offset=273.15,
    temperature_scale=1.0,
    energy=1000.0,  # kJ
)

LAB = UnitSystem(
    name="LAB",
    pressure=ATM,
    length=0.01,
    time=HOUR,
    density=1000.0,  # g/cc
    liquid_volume=1e-6,  # cc
    gas_volume=1e-6,
    reservoir_volume=1e-6,
    viscosity=CP,
    permeability=MILLIDARCY,
    temperature_offset=273.15,
    temperature_scale=1.0,
)

SI = UnitSystem(
    name="SI",
    pressure=1.0,
    length=1.0,
    time=1.0,
    density=1.0,
    liquid_volume=1.0,
    gas_volume=1.0,
    reservoir_volume=1.0,
    viscosity=1.0,
    permeability=1.0,
    temperature_offset=0.0,
    temperature_scale=1.0,
)

BY_NAME = {u.name: u for u in (FIELD, METRIC, LAB, SI)}

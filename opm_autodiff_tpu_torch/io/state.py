"""Deck -> EclState: the semantic model built from a parsed deck.

Replaces the slice of opm-common's ``EclipseState``/``Schedule`` that the
reference's call stacks traverse (SURVEY.md §0.1). All quantities are
converted to SI here. Grid arrays are stored in ECLIPSE natural order
(I fastest, then J, then K) as flat numpy arrays of length nx*ny*nz.
"""

from __future__ import annotations

import dataclasses
import datetime
import numpy as np

from opm_autodiff_tpu_torch import units as U
from opm_autodiff_tpu_torch.io.deck import DEFAULT, Deck, read_deck

MONTHS = {m: i + 1 for i, m in enumerate(
    ["JAN", "FEB", "MAR", "APR", "MAY", "JUN",
     "JLY", "AUG", "SEP", "OCT", "NOV", "DEC"])}
MONTHS["JUL"] = 7


def item(rec: list, idx: int, default=None):
    """Record item with ECL default semantics."""
    if idx >= len(rec) or rec[idx] is DEFAULT:
        return default
    return rec[idx]


# ---------------------------------------------------------------------------
# Section dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Runspec:
    phases: frozenset  # subset of {"OIL","WATER","GAS"}
    disgas: bool
    vapoil: bool
    unit_system: U.UnitSystem
    cartdims: tuple[int, int, int]
    start: datetime.date
    title: str = ""
    # active extended black-oil components (POLYMER/BRINE/FOAM/SOLVENT/
    # THERMAL runspec flags; reference: Main.hpp:202 dispatchDynamic_)
    extensions: frozenset = frozenset()
    # NOSIM: initialize + write output, skip time stepping
    # (reference: FlowMainEbos.hpp:507-524)
    nosim: bool = False
    # NUPCOL: group-control targets re-apportioned inside the Newton
    # loop up to this iteration, then frozen (reference:
    # BlackoilWellModel_impl.hpp:828 iterationIdx < nupcol)
    nupcol: int = 12


@dataclasses.dataclass
class GridSection:
    # flat natural-order arrays, SI
    dx: np.ndarray
    dy: np.ndarray
    dz: np.ndarray
    depth: np.ndarray  # cell-center depth (positive downward), m
    poro: np.ndarray
    permx: np.ndarray
    permy: np.ndarray
    permz: np.ndarray
    ntg: np.ndarray
    actnum: np.ndarray  # int
    multx: np.ndarray
    multy: np.ndarray
    multz: np.ndarray
    multpv: np.ndarray
    # negative-direction transmissibility multipliers (MULTX- etc.):
    # cell i's value scales the face on its -X/-Y/-Z side
    multxm: np.ndarray | None = None
    multym: np.ndarray | None = None
    multzm: np.ndarray | None = None
    # corner-point geometry (None for cartesian DX/DY/DZ decks), SI
    coord: np.ndarray | None = None
    zcorn: np.ndarray | None = None


@dataclasses.dataclass
class PvtwRecord:
    p_ref: float
    b_ref: float  # Bw at p_ref
    comp: float
    visc: float
    viscosibility: float


@dataclasses.dataclass
class RockRecord:
    p_ref: float
    comp: float


@dataclasses.dataclass
class DensityRecord:
    oil: float
    water: float
    gas: float


@dataclasses.dataclass
class PvtoTable:
    """Live-oil table: saturated curve + undersaturated branches.

    rs[i]: Rs of branch i (SI m3/m3); each branch: pressures [Pa],
    Bo, mu_o arrays (first point of the branch is the saturated point).
    """
    rs: np.ndarray  # [nb]
    branches: list  # list of (p[nk], bo[nk], mu[nk]) arrays


@dataclasses.dataclass
class PvtgTable:
    """Wet-gas table: per pressure node, Rv branches.

    p[i]: pressure of branch i (Pa); each branch: rv, Bg, mu_g arrays
    (first row is the saturated point at that pressure).
    """
    p: np.ndarray   # [np]
    branches: list  # list of (rv[nk], bg[nk], mu[nk]) arrays


@dataclasses.dataclass
class PropsSection:
    pvtw: PvtwRecord
    rock: RockRecord
    density: DensityRecord
    pvdg: np.ndarray | None  # [n,3]: p, Bg, mu_g  (SI)
    pvdo: np.ndarray | None  # [n,3]: p, Bo, mu_o
    pvto: PvtoTable | None
    swof: np.ndarray | None  # [n,4]: Sw, krw, krow, Pcow (region 1)
    sgof: np.ndarray | None  # [n,4]: Sg, krg, krog, Pcog (region 1)
    swfn: np.ndarray | None
    sgfn: np.ndarray | None
    sof3: np.ndarray | None
    # per-SATNUM-region tables (list of [n,4]; entry 0 == swof/sgof)
    swof_regions: list = dataclasses.field(default_factory=list)
    sgof_regions: list = dataclasses.field(default_factory=list)
    # saturation family II (SWFN/SGFN/SOF3) and the gas-water SGWFN
    # family — synthesized into SWOF/SGOF banks by _synthesize_satfam
    swfn_regions: list = dataclasses.field(default_factory=list)
    sgfn_regions: list = dataclasses.field(default_factory=list)
    sof3_regions: list = dataclasses.field(default_factory=list)
    sgwfn_regions: list = dataclasses.field(default_factory=list)
    # per-PVTNUM-region tables/records (entry 0 == the scalar fields)
    pvtw_regions: list = dataclasses.field(default_factory=list)
    rock_regions: list = dataclasses.field(default_factory=list)
    density_regions: list = dataclasses.field(default_factory=list)
    pvdg_regions: list = dataclasses.field(default_factory=list)
    pvdo_regions: list = dataclasses.field(default_factory=list)
    pvto_regions: list = dataclasses.field(default_factory=list)
    pvtg_regions: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EquilRecord:
    datum_depth: float
    datum_pressure: float
    woc_depth: float
    woc_pc: float
    goc_depth: float
    goc_pc: float
    rs_method: int  # live-oil init: 0 = const at Pb/datum, >0 use RSVD
    rv_method: int
    accuracy: int


@dataclasses.dataclass
class SolutionSection:
    equil: EquilRecord | None
    rsvd: np.ndarray | None  # [n,2]: depth, Rs (region 1)
    pressure: np.ndarray | None  # explicit init
    swat: np.ndarray | None
    sgas: np.ndarray | None
    rs: np.ndarray | None
    rv: np.ndarray | None = None
    restart: tuple | None = None  # (basename, report_step)
    rvvd_regions: list = dataclasses.field(default_factory=list)
    pbvd_regions: list = dataclasses.field(default_factory=list)
    pdvd_regions: list = dataclasses.field(default_factory=list)
    # per-EQLNUM-region records/tables (entry 0 == equil/rsvd)
    equil_regions: list = dataclasses.field(default_factory=list)
    rsvd_regions: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Completion:
    i: int  # 0-based
    j: int
    k: int
    open: bool
    cf: float | None  # connection trans factor, SI (m^3); None = compute
    diameter: float
    kh: float | None
    skin: float
    direction: str  # 'X','Y','Z'
    pi_mult: float = 1.0  # WPIMULT connection-factor multiplier
    lump: int = 0  # COMPLUMP completion number (0 = unassigned)


@dataclasses.dataclass
class Segment:
    """One wellbore segment (WELSEGS; ECL numbering: segment 1 = top).

    length/depth are ABSOLUTE (from wellhead / datum) after parsing —
    'INC' decks are converted by chaining along outlets.
    """
    number: int
    branch: int
    outlet: int  # outlet segment number (0 for the top segment)
    length: float  # measured depth along tubing to the segment node, m
    depth: float   # true vertical depth of the segment node, m
    diam: float
    rough: float
    area: float
    volume: float


@dataclasses.dataclass
class CompSeg:
    """COMPSEGS record: maps a completion to a branch length interval."""
    i: int  # 0-based
    j: int
    k: int
    branch: int
    start: float  # distance along the branch, m
    end: float


@dataclasses.dataclass
class WellConfig:
    name: str
    group: str
    i: int  # 0-based heel location
    j: int
    ref_depth: float | None
    preferred_phase: str
    is_injector: bool
    status: str  # OPEN/SHUT/STOP
    completions: list  # list[Completion]
    # control
    control_mode: str  # ORAT/WRAT/GRAT/LRAT/RESV/BHP/THP/RATE
    oil_rate: float | None = None  # SI m^3/s surface targets (None = absent)
    water_rate: float | None = None
    gas_rate: float | None = None
    liquid_rate: float | None = None
    resv_rate: float | None = None
    bhp_limit: float | None = None  # min for producer, max for injector
    thp_limit: float | None = None
    inj_phase: str | None = None  # GAS/WATER/OIL
    inj_rate: float | None = None
    # WECON economic limits
    econ_min_oil: float | None = None
    econ_min_gas: float | None = None
    econ_max_wct: float | None = None
    econ_max_gor: float | None = None
    econ_max_wgr: float | None = None
    # WECON item 7 workover procedure: NONE / CON / +CON / WELL
    econ_workover: str = "NONE"
    vfp_table: int | None = None  # VFPPROD table number (THP control)
    wtest_interval: float | None = None  # days between WTEST retests
    # WELPI: rescale the well's total productivity index to this target
    # (SI rate/pressure; reference: WellProdIndexCalculator + the
    # BlackoilWellModel WELPI handling)
    welpi_target: float | None = None
    # multisegment well description (None => standard well)
    segments: list | None = None   # list[Segment]
    compsegs: list | None = None   # list[CompSeg]
    pd_model: str = "HF-"          # pressure-drop components (WELSEGS item 6)
    # extended-component injection concentrations (SI mass/volume)
    poly_conc: float = 0.0         # WPOLYMER
    salt_conc: float = 0.0         # WSALT / WPOLYMER item 3
    foam_conc: float = 0.0         # WFOAM
    efac: float = 1.0              # WEFAC*GEFAC well efficiency factor
    rft: bool = False              # WRFTPLT: write RFT data for this well
    solv_frac: float = 0.0         # WSOLVENT: solvent fraction of gas inj
    temp_inj: float | None = None  # WTEMP / WINJTEMP: injection temp (K)
    # gas lift (WLIFTOPT; ALQ quantities stay in DECK units — they only
    # feed the VFP ALQ axis, which is parsed unscaled too)
    glift_on: bool = False
    glift_max_alq: float | None = None
    glift_min_alq: float = 0.0
    glift_weight: float = 1.0
    glift_gas_weight: float = 0.0


@dataclasses.dataclass
class ReportStep:
    start_days: float  # since simulation start (SI seconds / DAY)
    end_days: float
    wells: list  # list[WellConfig] snapshot active during this step
    groups: dict = dataclasses.field(default_factory=dict)
    # gas lift optimization config (LIFTOPT/GLIFTOPT; deck units)
    liftopt: dict = dataclasses.field(default_factory=dict)
    # TUNING overrides for the adaptive timestepper (days); None = keep
    tuning: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Schedule:
    steps: list  # list[ReportStep]


@dataclasses.dataclass
class SummaryConfig:
    keywords: list  # list of (mnemonic, [names])


@dataclasses.dataclass
class EclState:
    runspec: Runspec
    grid: GridSection
    props: PropsSection
    regions: dict
    solution: SolutionSection
    summary: SummaryConfig
    schedule: Schedule
    aquifers: dict = dataclasses.field(default_factory=dict)
    tracers: dict = dataclasses.field(default_factory=dict)
    # extended black-oil component tables (PLYVISC/PLYADS/PLYROCK/...)
    components: dict = dataclasses.field(default_factory=dict)
    # end-point-scaling grid arrays (SWL/SWCR/.../PCW/SWATINIT), deck units
    eps_arrays: dict = dataclasses.field(default_factory=dict)
    # raw UDQ / ACTIONX keyword objects (runtime-evaluated; actions.py)
    udq_keywords: list = dataclasses.field(default_factory=list)
    action_keywords: list = dataclasses.field(default_factory=list)
    vfp_prod_records: list = dataclasses.field(default_factory=list)
    vfp_inj_records: list = dataclasses.field(default_factory=list)
    nnc: list = dataclasses.field(default_factory=list)  # (ijk1, ijk2, trans SI)
    # EDITNNC multipliers: (ijk1, ijk2, mult) applied to any connection
    # joining the two cells (reference: ecltransmissibility.cc
    # applyEditNncToGridTrans_)
    editnnc: list = dataclasses.field(default_factory=list)
    thpres: list = dataclasses.field(default_factory=list)  # (r1, r2, dp SI)
    # named fault faces (FAULTS): name -> [(i1,i2,j1,j2,k1,k2,face)],
    # 0-based inclusive ranges; MULTFLT: name -> multiplier
    faults: dict = dataclasses.field(default_factory=dict)
    multflt: dict = dataclasses.field(default_factory=dict)
    # presence flags for option keywords (PINCH, EHYSTR, ...)
    flags: frozenset = frozenset()
    # EHYSTR record (curvature parameter, model flag): model 1 =
    # Killough kr + pc, 2 = Killough kr only (the default mirrors
    # ECLIPSE: 0.1, 2 -> relative-permeability hysteresis only)
    ehystr: tuple = (0.1, 2)

    @property
    def cartdims(self):
        return self.runspec.cartdims


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _grid_array_plain(deck: Deck, name: str, ncells: int, default=None,
                      dtype=float):
    kws = deck.get(name)
    if not kws:
        if default is None:
            return None
        return np.full(ncells, default, dtype)
    vals = [default if v is DEFAULT else v for v in kws[-1].records[0]]
    arr = np.asarray(vals, dtype)
    if arr.size < ncells:
        # ECL allows short arrays for e.g. TOPS (only the top layer)
        pad = np.full(ncells - arr.size, np.nan if dtype is float else 0, dtype)
        arr = np.concatenate([arr, pad])
    return arr[:ncells]


# callers outside the grid section (solution arrays etc.) use the plain form
_grid_array = _grid_array_plain


def _build_runspec(deck: Deck) -> Runspec:
    dims = deck.get1("DIMENS")
    cartdims = tuple(int(x) for x in dims.records[0][:3]) if dims else (1, 1, 1)
    phases = set()
    for ph in ("OIL", "WATER", "GAS"):
        if ph in deck:
            phases.add(ph)
    unit = U.METRIC
    for name in ("FIELD", "METRIC", "LAB"):
        if name in deck:
            unit = U.BY_NAME[name]
    start = datetime.date(1983, 1, 1)
    kw = deck.get1("START")
    if kw and kw.records and kw.records[0]:
        r = kw.records[0]
        day = int(item(r, 0, 1))
        mon = MONTHS.get(str(item(r, 1, "JAN")).upper().strip("'\""), 1)
        year = int(item(r, 2, 1983))
        start = datetime.date(year, mon, day)
    ext = {e for e in ("POLYMER", "BRINE", "FOAM", "SOLVENT", "THERMAL",
                       "MISCIBLE")
           if e in deck}
    if "TEMP" in deck:
        ext.add("THERMAL")
    if "PVTSOL" in deck:
        # extended black-oil (zFraction) model — the reference
        # dispatches on Phase::ZFRACTION (Main.hpp:309, flow_ebos_extbo)
        ext.add("EXTBO")
    return Runspec(
        phases=frozenset(phases),
        disgas="DISGAS" in deck,
        vapoil="VAPOIL" in deck,
        unit_system=unit,
        cartdims=cartdims,
        start=start,
        extensions=frozenset(ext),
        nosim="NOSIM" in deck,
        nupcol=(int(item(deck.get1("NUPCOL").records[0], 0, 12))
                if deck.get1("NUPCOL") is not None else 12),
    )


def _apply_box_operations(deck: Deck, cartdims) -> dict:
    """Process BOX/ENDBOX + EQUALS/COPY/ADD/MULTIPLY in deck order.

    Returns {array_name: np.ndarray} overlays in deck units (reference:
    opm-common's GridSection box operations; heavily used by SPE9/Norne
    decks). Plain array keywords already in the deck seed the values;
    operations then modify them in order.
    """
    nx, ny, nz = cartdims
    n = nx * ny * nz
    arrays: dict[str, np.ndarray] = {}
    full_box = (0, nx - 1, 0, ny - 1, 0, nz - 1)
    box = full_box

    def sel(b):
        i1, i2, j1, j2, k1, k2 = b
        m = np.zeros((nz, ny, nx), bool)
        m[k1:k2 + 1, j1:j2 + 1, i1:i2 + 1] = True
        return m.reshape(-1)

    def get(name):
        if name not in arrays:
            kws = deck.get(name)
            if kws:
                vals = [np.nan if v is DEFAULT else v
                        for v in kws[-1].records[0]]
                a = np.full(n, np.nan)
                a[:min(len(vals), n)] = vals[:n]
                arrays[name] = a
            else:
                arrays[name] = np.full(n, np.nan)
        return arrays[name]

    def rec_box(r, start):
        vals = [item(r, start + i, None) for i in range(6)]
        if all(v is None for v in vals):
            return box
        i1 = int(item(r, start + 0, box[0] + 1)) - 1
        i2 = int(item(r, start + 1, box[1] + 1)) - 1
        j1 = int(item(r, start + 2, box[2] + 1)) - 1
        j2 = int(item(r, start + 3, box[3] + 1)) - 1
        k1 = int(item(r, start + 4, box[4] + 1)) - 1
        k2 = int(item(r, start + 5, box[5] + 1)) - 1
        return (i1, i2, j1, j2, k1, k2)

    for kw in deck:
        if kw.name == "BOX" and kw.records:
            r = kw.records[0]
            box = (int(item(r, 0, 1)) - 1, int(item(r, 1, nx)) - 1,
                   int(item(r, 2, 1)) - 1, int(item(r, 3, ny)) - 1,
                   int(item(r, 4, 1)) - 1, int(item(r, 5, nz)) - 1)
        elif kw.name == "ENDBOX":
            box = full_box
        elif kw.name == "EQUALS":
            for r in kw.records:
                name = str(item(r, 0, "")).upper()
                val = float(item(r, 1, 0.0))
                get(name)[sel(rec_box(r, 2))] = val
        elif kw.name == "COPY":
            for r in kw.records:
                src = str(item(r, 0, "")).upper()
                dst = str(item(r, 1, "")).upper()
                m = sel(rec_box(r, 2))
                get(dst)[m] = get(src)[m]
        elif kw.name == "ADD":
            for r in kw.records:
                name = str(item(r, 0, "")).upper()
                val = float(item(r, 1, 0.0))
                get(name)[sel(rec_box(r, 2))] += val
        elif kw.name == "MULTIPLY":
            for r in kw.records:
                name = str(item(r, 0, "")).upper()
                val = float(item(r, 1, 0.0))
                get(name)[sel(rec_box(r, 2))] *= val
        elif kw.name == "MULTIREG":
            # region-based multiply: (array, value, region number,
            # region keyword selector M/F/O -> MULTNUM/FLUXNUM/OPERNUM)
            for r in kw.records:
                name = str(item(r, 0, "")).upper()
                val = float(item(r, 1, 1.0))
                regno = int(item(r, 2, 0))
                which = str(item(r, 3, "M")).upper()[:1]
                regkw = {"M": "MULTNUM", "F": "FLUXNUM",
                         "O": "OPERNUM"}.get(which, "MULTNUM")
                m = get(regkw) == regno
                get(name)[m] *= val
    return arrays


def _build_grid(deck: Deck, rs: Runspec) -> GridSection:
    nx, ny, nz = rs.cartdims
    n = nx * ny * nz
    u = rs.unit_system
    overlays = _apply_box_operations(deck, rs.cartdims)

    def _grid_array(deck_, name, ncells, default=None, dtype=float):
        ov = overlays.get(name)
        base = _grid_array_plain(deck_, name, ncells, default, dtype)
        if ov is None or np.all(np.isnan(ov)):
            return base
        if base is None:
            base = np.full(ncells, np.nan if default is None else default,
                           dtype)
        out = np.where(np.isnan(ov), base, ov)
        return out.astype(dtype) if dtype is not float else out

    def vec_expand(name_v, name_full, axis):
        """DXV-style per-slice values expanded to the full grid."""
        kw = deck.get1(name_v)
        if kw is None:
            return _grid_array(deck, name_full, n)
        v = np.asarray([x for x in kw.records[0] if x is not DEFAULT], float)
        if axis == 0:
            return np.tile(v, ny * nz)
        if axis == 1:
            return np.tile(np.repeat(v, nx), nz)
        return np.repeat(v, nx * ny)

    coord_kw = deck.get1("COORD")
    zcorn_kw = deck.get1("ZCORN")
    coord = zcorn = None
    if coord_kw is not None and zcorn_kw is not None:
        coord = np.asarray([v for v in coord_kw.records[0]
                            if v is not DEFAULT], float) * u.length
        zcorn = np.asarray([v for v in zcorn_kw.records[0]
                            if v is not DEFAULT], float) * u.length
        if coord.size != (nx + 1) * (ny + 1) * 6:
            raise ValueError("COORD size mismatch")
        if zcorn.size != 8 * n:
            raise ValueError("ZCORN size mismatch")
        # nominal dx/dy/dz/depth from corner spans (refined by the
        # corner-point geometry builder; placeholders keep the section
        # uniform for output modules)
        zc = zcorn.reshape(nz, 2, ny, 2, nx, 2)
        dz = (zc[:, 1].mean(axis=(1, 3)) - zc[:, 0].mean(axis=(1, 3)))
        dz = np.abs(dz).reshape(-1)
        depth = 0.5 * (zc[:, 1].mean(axis=(1, 3))
                       + zc[:, 0].mean(axis=(1, 3))).reshape(-1)
        cr = coord.reshape(ny + 1, nx + 1, 6)
        dxs = np.diff(cr[:-1, :, 0], axis=1).mean()
        dys = np.diff(cr[:, :-1, 1], axis=0).mean()
        dx = np.full(n, max(dxs, 1e-3))
        dy = np.full(n, max(dys, 1e-3))
    else:
        dx = vec_expand("DXV", "DX", 0)
        dy = vec_expand("DYV", "DY", 1)
        dz = vec_expand("DZV", "DZ", 2)
        if dx is None or dy is None or dz is None:
            raise ValueError(
                "grid geometry requires DX/DY/DZ or COORD/ZCORN")
        dx = dx * u.length
        dy = dy * u.length
        dz = dz * u.length

        tops = _grid_array(deck, "TOPS", n)
        if tops is None:
            # DEPTHZ: corner depths of the top surface ((nx+1)*(ny+1)
            # values) — average the 4 corners per cell (reference
            # fixture equil_capillary.DATA uses this form)
            kw_dz = deck.get1("DEPTHZ")
            if kw_dz and kw_dz.records:
                vals = [v for r in kw_dz.records for v in r
                        if v is not DEFAULT]
                need = (nx + 1) * (ny + 1)
                if len(vals) < need:  # trailing defaults repeat last
                    vals = list(vals) + [vals[-1]] * (need - len(vals))
                c = np.asarray(vals[:need], float).reshape(ny + 1,
                                                           nx + 1)
                top1 = 0.25 * (c[:-1, :-1] + c[:-1, 1:]
                               + c[1:, :-1] + c[1:, 1:])
                tops = np.full(n, np.nan)
                tops[: nx * ny] = top1.reshape(-1)
            else:
                raise ValueError(
                    "TOPS or DEPTHZ required for cartesian geometry")
        tops = tops * u.length
        # fill deeper layers: top(k) = top(k-1) + dz(k-1)
        tops3 = tops.reshape(nz, ny, nx)
        dz3 = dz.reshape(nz, ny, nx)
        for k in range(1, nz):
            if np.isnan(tops3[k]).any():
                tops3[k] = tops3[k - 1] + dz3[k - 1]
        depth = (tops3 + 0.5 * dz3).reshape(-1)

    poro = _grid_array(deck, "PORO", n, 0.0)
    permx = _grid_array(deck, "PERMX", n, 0.0) * u.permeability
    permy_kw = _grid_array(deck, "PERMY", n)
    permy = permy_kw * u.permeability if permy_kw is not None else permx.copy()
    permz_kw = _grid_array(deck, "PERMZ", n)
    permz = permz_kw * u.permeability if permz_kw is not None else permx.copy()
    ntg = _grid_array(deck, "NTG", n, 1.0)
    actnum = _grid_array(deck, "ACTNUM", n, 1, dtype=int)
    multx = _grid_array(deck, "MULTX", n, 1.0)
    multy = _grid_array(deck, "MULTY", n, 1.0)
    multz = _grid_array(deck, "MULTZ", n, 1.0)
    multxm = _grid_array(deck, "MULTX-", n, 1.0)
    multym = _grid_array(deck, "MULTY-", n, 1.0)
    multzm = _grid_array(deck, "MULTZ-", n, 1.0)
    multpv = _grid_array(deck, "MULTPV", n, 1.0)
    # zero-porosity cells are inactive
    actnum = np.where(poro <= 0.0, 0, actnum)
    # MINPV: deactivate cells below the pore-volume threshold
    # (reference: MINPV handling in the vanguards, eclbasevanguard.hh;
    # the reference can also merge thin cells — here they deactivate)
    kw = deck.get1("MINPV")
    if kw is not None and coord is None:
        vals = [v for v in kw.flat() if v is not DEFAULT]
        minpv = (np.full(n, float(vals[0])) if len(vals) == 1
                 else np.asarray(vals, float))
        pv = dx * dy * dz * poro * ntg * multpv
        actnum = np.where(pv < minpv * u.reservoir_volume, 0, actnum)
    return GridSection(dx, dy, dz, depth, poro, permx, permy, permz, ntg,
                       actnum, multx, multy, multz, multpv,
                       multxm=multxm, multym=multym, multzm=multzm,
                       coord=coord, zcorn=zcorn)


def _table_2d(kw, ncols: int, scales: list[float]) -> np.ndarray:
    vals = [v for v in kw.flat() if v is not DEFAULT]
    arr = np.asarray(vals, float).reshape(-1, ncols)
    return arr * np.asarray(scales)


def _table_2d_regions(kw, ncols: int, scales: list[float]) -> list:
    """One table per record (per SATNUM region)."""
    out = []
    for rec in kw.records:
        vals = [v for v in rec if v is not DEFAULT]
        if not vals:
            continue
        out.append(np.asarray(vals, float).reshape(-1, ncols)
                   * np.asarray(scales))
    return out


def _build_pvtg_regions(kw, u: U.UnitSystem) -> list:
    """PVTG tables, one per PVTNUM region (empty records separate)."""
    tables = []
    p_list, branches = [], []
    for rec in kw.records:
        vals = [v for v in rec if v is not DEFAULT]
        if not vals:
            if p_list:
                tables.append(PvtgTable(np.asarray(p_list), branches))
                p_list, branches = [], []
            elif tables:
                tables.append(tables[-1])
            continue
        pres = vals[0] * u.pressure
        rest = np.asarray(vals[1:], float).reshape(-1, 3)
        rv = rest[:, 0] * u.oil_gas_ratio
        bg = rest[:, 1] * u.gas_fvf
        mu = rest[:, 2] * u.viscosity
        p_list.append(pres)
        branches.append((rv, bg, mu))
    if p_list:
        tables.append(PvtgTable(np.asarray(p_list), branches))
    return tables


def _build_pvto_regions(kw, u: U.UnitSystem) -> list:
    """PVTO tables, one per PVTNUM region (regions separated by empty
    records — the lone '/' closing each region's table)."""
    tables = []
    rs_list, branches = [], []
    for rec in kw.records:
        vals = [v for v in rec if v is not DEFAULT]
        if not vals:  # region separator
            if rs_list:
                tables.append(PvtoTable(np.asarray(rs_list), branches))
                rs_list, branches = [], []
            elif tables:
                # fully-defaulted region table: copy the previous one
                tables.append(tables[-1])
            continue
        rs = vals[0] * u.gas_oil_ratio
        rest = np.asarray(vals[1:], float).reshape(-1, 3)
        p = rest[:, 0] * u.pressure
        bo = rest[:, 1] * u.oil_fvf
        mu = rest[:, 2] * u.viscosity
        rs_list.append(rs)
        branches.append((p, bo, mu))
    if rs_list:
        tables.append(PvtoTable(np.asarray(rs_list), branches))
    return tables


def _build_props(deck: Deck, rs: Runspec) -> PropsSection:
    u = rs.unit_system

    def one_pvtw(r):
        return PvtwRecord(
            p_ref=item(r, 0, 1.0) * u.pressure,
            b_ref=item(r, 1, 1.0) * u.oil_fvf,
            comp=item(r, 2, 4e-5 / U.BAR * u.pressure) * u.compressibility,
            visc=item(r, 3, 0.5) * u.viscosity,
            viscosibility=item(r, 4, 0.0) * u.compressibility,
        )

    pvtw_kw = deck.get1("PVTW")
    if pvtw_kw and pvtw_kw.records:
        pvtw_regions = [one_pvtw(r) for r in pvtw_kw.records if r]
    else:
        pvtw_regions = [PvtwRecord(U.ATM, 1.0, 4e-10, 5e-4, 0.0)]
    pvtw = pvtw_regions[0]

    rock_kw = deck.get1("ROCK")
    if rock_kw and rock_kw.records:
        rock_regions = [RockRecord(item(r, 0, 1.0) * u.pressure,
                                   item(r, 1, 0.0) * u.compressibility)
                        for r in rock_kw.records if r]
    else:
        rock_regions = [RockRecord(U.ATM, 0.0)]
    rock = rock_regions[0]

    dens_kw = deck.get1("DENSITY")
    grav_kw = deck.get1("GRAVITY")
    if dens_kw and dens_kw.records:
        density_regions = [DensityRecord(item(r, 0, 600.0) * u.density,
                                         item(r, 1, 1000.0) * u.density,
                                         item(r, 2, 1.0) * u.density)
                           for r in dens_kw.records if r]
    elif grav_kw and grav_kw.records:
        # GRAVITY: oil API gravity, water specific gravity, gas specific
        # gravity (vs air) — the DENSITY alternative (dimensionless, so
        # no unit scaling; standard freshwater 999.014 kg/m3, air
        # 1.22 kg/m3)
        density_regions = [DensityRecord(
            141.5 / (131.5 + item(r, 0, 35.0)) * 999.014,
            item(r, 1, 1.0) * 999.014,
            item(r, 2, 0.7773) * 1.22)
            for r in grav_kw.records if r]
    else:
        density_regions = [DensityRecord(600.0, 1000.0, 1.0)]
    density = density_regions[0]

    def t(name, ncols, scales):
        kw = deck.get1(name)
        return _table_2d(kw, ncols, scales) if kw else None

    def t_regions(name, ncols, scales):
        kw = deck.get1(name)
        return _table_2d_regions(kw, ncols, scales) if kw else []

    pvdg_regions = t_regions("PVDG", 3, [u.pressure, u.gas_fvf, u.viscosity])
    pvdo_regions = t_regions("PVDO", 3, [u.pressure, u.oil_fvf, u.viscosity])
    if not pvdo_regions:
        # PVCDO: dead oil with constant compressibility/viscosibility
        # (the PVTW-shaped record); synthesize a dense PVDO table from
        # the analytic second-order expansions — exact to interpolation
        # tolerance over the sampled range
        kw = deck.get1("PVCDO")
        if kw and kw.records:
            for r in kw.records:
                if not r:
                    continue
                p_ref = item(r, 0, 1.0) * u.pressure
                b_ref = item(r, 1, 1.0) * u.oil_fvf
                comp = item(r, 2, 0.0) / u.pressure
                mu_ref = item(r, 3, 1.0) * u.viscosity
                visco = item(r, 4, 0.0) / u.pressure
                p = np.linspace(1e5, 1.0e9, 200)
                x = comp * (p - p_ref)
                b = b_ref / (1.0 + x + 0.5 * x * x)
                y = -visco * (p - p_ref)
                mu = mu_ref / (1.0 + y + 0.5 * y * y)
                pvdo_regions.append(np.stack([p, b, mu], axis=1))
    pvdg = pvdg_regions[0] if pvdg_regions else None
    pvdo = pvdo_regions[0] if pvdo_regions else None
    swof_kw = deck.get1("SWOF")
    sgof_kw = deck.get1("SGOF")
    swof_regions = (_table_2d_regions(swof_kw, 4, [1.0, 1.0, 1.0, u.pressure])
                    if swof_kw else [])
    sgof_regions = (_table_2d_regions(sgof_kw, 4, [1.0, 1.0, 1.0, u.pressure])
                    if sgof_kw else [])
    if not sgof_regions:
        # SLGOF: the family-I alternative tabulated against LIQUID
        # saturation (SL = 1 - Sg); reversed it IS an SGOF table
        slgof_kw = deck.get1("SLGOF")
        if slgof_kw:
            for tab in _table_2d_regions(slgof_kw, 4,
                                         [1.0, 1.0, 1.0, u.pressure]):
                tt = tab[::-1].copy()
                tt[:, 0] = 1.0 - tt[:, 0]
                sgof_regions.append(tt)
    swof = swof_regions[0] if swof_regions else None
    sgof = sgof_regions[0] if sgof_regions else None
    swfn = t("SWFN", 3, [1.0, 1.0, u.pressure])
    sgfn = t("SGFN", 3, [1.0, 1.0, u.pressure])
    sof3 = t("SOF3", 3, [1.0, 1.0, 1.0])
    swfn_regions = t_regions("SWFN", 3, [1.0, 1.0, u.pressure])
    sgfn_regions = t_regions("SGFN", 3, [1.0, 1.0, u.pressure])
    sof3_regions = t_regions("SOF3", 3, [1.0, 1.0, 1.0])
    if not sof3_regions:
        # SOF2 (two-phase oil functions): one kro column serves both
        # the oil-water and oil-gas roles of SOF3
        sof2 = t_regions("SOF2", 2, [1.0, 1.0])
        sof3_regions = [np.column_stack([t[:, 0], t[:, 1], t[:, 1]])
                        for t in sof2]
    sgwfn_regions = t_regions("SGWFN", 4, [1.0, 1.0, 1.0, u.pressure])
    pvto_kw = deck.get1("PVTO")
    pvto_regions = _build_pvto_regions(pvto_kw, u) if pvto_kw else []
    pvto = pvto_regions[0] if pvto_regions else None
    pvtg_kw = deck.get1("PVTG")
    pvtg_regions = _build_pvtg_regions(pvtg_kw, u) if pvtg_kw else []
    return PropsSection(pvtw, rock, density, pvdg, pvdo, pvto, swof, sgof,
                        swfn, sgfn, sof3,
                        swfn_regions=swfn_regions,
                        sgfn_regions=sgfn_regions,
                        sof3_regions=sof3_regions,
                        sgwfn_regions=sgwfn_regions,
                        swof_regions=swof_regions,
                        sgof_regions=sgof_regions,
                        pvtw_regions=pvtw_regions,
                        rock_regions=rock_regions,
                        density_regions=density_regions,
                        pvdg_regions=pvdg_regions,
                        pvdo_regions=pvdo_regions,
                        pvto_regions=pvto_regions,
                        pvtg_regions=pvtg_regions)


def _synthesize_satfam(props: PropsSection, phases) -> PropsSection:
    """Convert saturation-function family II (SWFN/SGFN/SOF3) and the
    gas-water SGWFN family into the internal SWOF/SGOF banks.

    Reference: opm-common's TableManager does the same family
    unification; flow's gas-water variant (flow_gaswater) consumes
    SGWFN. Piecewise-linear resampling on the union of the relevant
    node sets is exact for these tables.
    """
    if props.swof_regions and props.sgof_regions:
        return props

    def interp(x, t, col):
        return np.interp(x, t[:, 0], t[:, col])

    swofs, sgofs = [], []
    if props.sgwfn_regions and "OIL" not in phases:
        # gas-water: SGWFN columns (Sg, krg, krw, Pcgw); sw = 1 - sg.
        # Pcgw rides the SGOF pc column: with So == 0 the phase
        # pressures give pg - pw = pcog(sg) + pcow(sw) = Pcgw + 0.
        for t in props.sgwfn_regions:
            sg = t[:, 0]
            sw = (1.0 - sg)[::-1]
            swofs.append(np.stack(
                [sw, t[::-1, 2], np.zeros_like(sw), np.zeros_like(sw)],
                axis=1))
            sgofs.append(np.stack(
                [sg, t[:, 1], np.zeros_like(sg), t[:, 3]], axis=1))
    elif props.swfn_regions and props.sgfn_regions:
        nr = max(len(props.swfn_regions), len(props.sgfn_regions),
                 len(props.sof3_regions) or 1)

        def reg(lst, i):
            return lst[min(i, len(lst) - 1)] if lst else None

        for i in range(nr):
            swfn = reg(props.swfn_regions, i)
            sgfn = reg(props.sgfn_regions, i)
            sof3 = reg(props.sof3_regions, i)
            swl = float(swfn[0, 0])
            if sof3 is not None and "OIL" in phases:
                # SWOF(sw): krow from SOF3 col 1 at so = 1 - sw
                sw = np.unique(np.concatenate(
                    [swfn[:, 0], np.clip(1.0 - sof3[:, 0], swfn[0, 0],
                                         swfn[-1, 0])]))
                krow = interp(1.0 - sw, sof3, 1)
                swofs.append(np.stack(
                    [sw, interp(sw, swfn, 1), krow,
                     interp(sw, swfn, 2)], axis=1))
                # SGOF(sg): krog from SOF3 col 2 at so = 1 - sg - swl
                sg = np.unique(np.concatenate(
                    [sgfn[:, 0], np.clip(1.0 - sof3[:, 0] - swl,
                                         sgfn[0, 0], sgfn[-1, 0])]))
                krog = interp(1.0 - sg - swl, sof3, 2)
                sgofs.append(np.stack(
                    [sg, interp(sg, sgfn, 1), krog,
                     interp(sg, sgfn, 2)], axis=1))
            else:
                # no oil functions: gas-water via SWFN + SGFN
                sw = swfn[:, 0]
                sg = sgfn[:, 0]
                swofs.append(np.stack(
                    [sw, swfn[:, 1], np.zeros_like(sw), swfn[:, 2]],
                    axis=1))
                sgofs.append(np.stack(
                    [sg, sgfn[:, 1], np.zeros_like(sg), sgfn[:, 2]],
                    axis=1))
    else:
        return props
    return dataclasses.replace(
        props, swof=swofs[0], sgof=sgofs[0],
        swof_regions=swofs, sgof_regions=sgofs)


def _build_solution(deck: Deck, rs: Runspec, ncells: int) -> SolutionSection:
    u = rs.unit_system
    equil_regions = []
    kw = deck.get1("EQUIL")
    if kw and kw.records:
        for r in kw.records:
            if not r:
                continue
            equil_regions.append(EquilRecord(
                datum_depth=item(r, 0, 0.0) * u.length,
                datum_pressure=item(r, 1, 0.0) * u.pressure,
                woc_depth=item(r, 2, 0.0) * u.length,
                woc_pc=item(r, 3, 0.0) * u.pressure,
                goc_depth=item(r, 4, 0.0) * u.length,
                goc_pc=item(r, 5, 0.0) * u.pressure,
                rs_method=int(item(r, 6, 0)),
                rv_method=int(item(r, 7, 0)),
                accuracy=int(item(r, 8, 0)),
            ))
    equil = equil_regions[0] if equil_regions else None
    rsvd_regions = []
    kw = deck.get1("RSVD")
    if kw and kw.records:
        for r in kw.records:
            vals = np.asarray([v for v in r if v is not DEFAULT],
                              float).reshape(-1, 2)
            if len(vals):
                rsvd_regions.append(
                    vals * np.asarray([u.length, u.gas_oil_ratio]))
    rsvd = rsvd_regions[0] if rsvd_regions else None

    def _depth_tables(name, col_scale):
        out = []
        kw2 = deck.get1(name)
        if kw2 and kw2.records:
            for r2 in kw2.records:
                vals = np.asarray([v for v in r2 if v is not DEFAULT],
                                  float).reshape(-1, 2)
                if len(vals):
                    out.append(vals * np.asarray([u.length, col_scale]))
        return out

    # initial-composition depth tables: RVVD (Rv vs depth), PBVD
    # (bubble point vs depth, the RSVD alternative), PDVD (dew point
    # vs depth, the RVVD alternative)
    rvvd_regions = _depth_tables("RVVD", 1.0 / u.gas_oil_ratio)
    pbvd_regions = _depth_tables("PBVD", u.pressure)
    pdvd_regions = _depth_tables("PDVD", u.pressure)

    def arr(name, scale=1.0):
        a = _grid_array(deck, name, ncells)
        return a * scale if a is not None else None

    restart = None
    kw = deck.get1("RESTART")
    if kw and kw.records and kw.records[0]:
        r = kw.records[0]
        restart = (str(item(r, 0, "")), int(item(r, 1, 0)))

    return SolutionSection(
        equil=equil,
        rsvd=rsvd,
        rvvd_regions=rvvd_regions,
        pbvd_regions=pbvd_regions,
        pdvd_regions=pdvd_regions,
        equil_regions=equil_regions,
        rsvd_regions=rsvd_regions,
        pressure=arr("PRESSURE", u.pressure),
        swat=arr("SWAT"),
        sgas=arr("SGAS"),
        rs=arr("RS", u.gas_oil_ratio),
        rv=arr("RV", u.oil_gas_ratio),
        restart=restart,
    )


def _build_summary(deck: Deck) -> SummaryConfig:
    out = []
    in_summary = False
    for kw in deck:
        if kw.name == "SUMMARY":
            in_summary = True
            continue
        if kw.name == "SCHEDULE":
            in_summary = False
        if not in_summary:
            continue
        names = [str(x) for x in (kw.records[0] if kw.records else [])
                 if x is not DEFAULT]
        out.append((kw.name, names))
    return SummaryConfig(out)


def _well_match(pattern: str, name: str) -> bool:
    """ECL well-name matching: literal or trailing-* wildcard."""
    import fnmatch

    return fnmatch.fnmatch(name, pattern)


def _apply_sched_keyword(kw, u, wells, group_tree, group_prod,
                         group_inj, liftopt, group_net=None,
                         group_aux=None):
    """Apply one schedule keyword to the mutable well/group state.

    Shared between the deck-order schedule builder and runtime ACTIONX
    payload application (reference: Schedule::applyAction in opm-common,
    consumed by EclProblem::applyActions, eclproblem.hh:1243).
    Returns True when the keyword was recognized.
    """
    if kw.name == "WELSPECS":
        for r in kw.records:
            name = str(item(r, 0, ""))
            wells[name] = WellConfig(
                name=name,
                group=str(item(r, 1, "FIELD")),
                i=int(item(r, 2, 1)) - 1,
                j=int(item(r, 3, 1)) - 1,
                ref_depth=(item(r, 4, None) * u.length
                           if item(r, 4, None) is not None else None),
                preferred_phase=str(item(r, 5, "OIL")),
                is_injector=False,
                status="SHUT",
                completions=[],
                control_mode="BHP",
            )
    elif kw.name == "COMPDAT":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells[name]
            i = int(item(r, 1, w.i + 1)) - 1
            j = int(item(r, 2, w.j + 1)) - 1
            k1 = int(item(r, 3, 1)) - 1
            k2 = int(item(r, 4, k1 + 1)) - 1
            stat = str(item(r, 5, "OPEN")).upper()
            cf = item(r, 7, None)
            diam = item(r, 8, 1.0 * U.FOOT / u.length) * u.length
            kh = item(r, 9, None)
            skin = item(r, 10, 0.0)
            direction = str(item(r, 12, "Z")).upper()
            for k in range(k1, k2 + 1):
                w.completions.append(Completion(
                    i=i, j=j, k=k, open=(stat == "OPEN"),
                    cf=cf * u.well_index if cf is not None else None,
                    diameter=diam,
                    kh=kh * u.permeability * u.length if kh is not None else None,
                    skin=skin, direction=direction))
    elif kw.name == "WELSEGS":
        # reference: WellSegments from opm-common, consumed by
        # MultisegmentWell (opm/simulators/wells/MultisegmentWell.hpp:35)
        recs = kw.records
        hdr = recs[0]
        name = str(item(hdr, 0, ""))
        w = wells[name]
        top_depth = item(hdr, 1, 0.0) * u.length
        top_len = item(hdr, 2, 0.0) * u.length
        wb_vol = item(hdr, 3, None)
        ltype = str(item(hdr, 4, "INC")).upper()
        w.pd_model = str(item(hdr, 5, "HF-")).upper()
        vol_scale = u.length ** 3
        segs = {1: Segment(1, 1, 0, top_len, top_depth, 0.1, 1e-5,
                           np.pi * 0.1 ** 2 / 4,
                           (wb_vol * vol_scale if wb_vol is not None
                            else 1e-3))}
        for r in recs[1:]:
            s1 = int(item(r, 0, 0))
            s2 = int(item(r, 1, s1))
            branch = int(item(r, 2, 1))
            outlet = int(item(r, 3, 1))
            ln = item(r, 4, 0.0) * u.length
            dp = item(r, 5, 0.0) * u.length
            diam = item(r, 6, 0.1 / u.length) * u.length
            rough = item(r, 7, 1e-5 / u.length) * u.length
            area = item(r, 8, None)
            vol = item(r, 9, None)
            nseg = s2 - s1 + 1
            for idx, sn in enumerate(range(s1, s2 + 1)):
                out = outlet if sn == s1 else sn - 1
                if ltype == "ABS":
                    # given length/depth apply to the LAST segment of
                    # the range; intermediates interpolate from the
                    # range's outlet node
                    ref = segs.get(outlet)
                    base_l = ref.length if ref else 0.0
                    base_d = ref.depth if ref else 0.0
                    f = (idx + 1) / nseg
                    sl = base_l + f * (ln - base_l)
                    sd = base_d + f * (dp - base_d)
                else:
                    sl, sd = ln, dp  # incremental; chained below
                a = (area * u.length ** 2 if area is not None
                     else np.pi * diam ** 2 / 4)
                segs[sn] = Segment(sn, branch, out, sl, sd, diam,
                                   rough, a,
                                   vol * vol_scale if vol is not None
                                   else 0.0)
        if ltype == "INC":
            # chain incremental length/depth along outlets to absolute
            done = {1}
            pending = [s for s in segs if s != 1]
            while pending:
                rest = []
                for sn in pending:
                    s = segs[sn]
                    if s.outlet in done:
                        o = segs[s.outlet]
                        s.length += o.length
                        s.depth += o.depth
                        done.add(sn)
                    else:
                        rest.append(sn)
                if len(rest) == len(pending):
                    raise ValueError(f"WELSEGS {name}: segment outlet "
                                     "cycle or missing outlet")
                pending = rest
        for s in segs.values():
            if s.volume == 0.0:
                o = segs.get(s.outlet)
                dl = abs(s.length - o.length) if o else 1.0
                s.volume = max(s.area * max(dl, 1e-3), 1e-4)
        w.segments = [segs[k2] for k2 in sorted(segs)]
    elif kw.name == "COMPSEGS":
        recs = kw.records
        name = str(item(recs[0], 0, ""))
        w = wells[name]
        w.compsegs = []
        for r in recs[1:]:
            w.compsegs.append(CompSeg(
                i=int(item(r, 0, 1)) - 1,
                j=int(item(r, 1, 1)) - 1,
                k=int(item(r, 2, 1)) - 1,
                branch=int(item(r, 3, 1)),
                start=item(r, 4, 0.0) * u.length,
                end=item(r, 5, 0.0) * u.length,
            ))
    elif kw.name == "WCONPROD":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells[name]
            w.is_injector = False
            w.status = str(item(r, 1, "OPEN")).upper()
            w.control_mode = str(item(r, 2, "BHP")).upper()
            w.oil_rate = _opt_rate(item(r, 3, None), u.liquid_rate)
            w.water_rate = _opt_rate(item(r, 4, None), u.liquid_rate)
            w.gas_rate = _opt_rate(item(r, 5, None), u.gas_rate)
            w.liquid_rate = _opt_rate(item(r, 6, None), u.liquid_rate)
            w.resv_rate = _opt_rate(item(r, 7, None), u.reservoir_rate)
            bhp = item(r, 8, None)
            w.bhp_limit = bhp * u.pressure if bhp is not None else U.ATM
            thp = item(r, 9, None)
            w.thp_limit = thp * u.pressure if thp is not None else None
            vfp = item(r, 10, None)
            w.vfp_table = int(vfp) if vfp else None
    elif kw.name == "WCONHIST":
        # history-matching producer control: observed rates become rate
        # targets with the preferred-phase mode (reference: opm-common
        # Schedule WCONHIST handling; flow treats them as targets)
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells[name]
            w.is_injector = False
            w.status = str(item(r, 1, "OPEN")).upper()
            mode = str(item(r, 2, "ORAT")).upper()
            w.control_mode = mode if mode in ("ORAT", "WRAT", "GRAT",
                                              "LRAT", "RESV", "BHP") \
                else "ORAT"
            w.oil_rate = _opt_rate(item(r, 3, None), u.liquid_rate)
            w.water_rate = _opt_rate(item(r, 4, None), u.liquid_rate)
            w.gas_rate = _opt_rate(item(r, 5, None), u.gas_rate)
            if w.oil_rate is not None and w.water_rate is not None:
                w.liquid_rate = w.oil_rate + w.water_rate
            vfp = item(r, 6, None)
            w.vfp_table = int(vfp) if vfp else w.vfp_table
            bhp = item(r, 9, None)
            if bhp is not None:
                w.bhp_limit = bhp * u.pressure
            elif w.bhp_limit is None:
                w.bhp_limit = U.ATM
    elif kw.name == "WCONINJH":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells[name]
            w.is_injector = True
            w.inj_phase = str(item(r, 1, "GAS")).upper()
            w.status = str(item(r, 2, "OPEN")).upper()
            rate_scale = (u.gas_rate if w.inj_phase == "GAS"
                          else u.liquid_rate)
            w.control_mode = "RATE"
            w.inj_rate = _opt_rate(item(r, 3, None), rate_scale)
            bhp = item(r, 4, None)
            w.bhp_limit = (bhp * u.pressure if bhp is not None else 6.9e8)
    elif kw.name == "WCONINJE":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells[name]
            w.is_injector = True
            w.inj_phase = str(item(r, 1, "GAS")).upper()
            w.status = str(item(r, 2, "OPEN")).upper()
            w.control_mode = str(item(r, 3, "RATE")).upper()
            rate_scale = (u.gas_rate if w.inj_phase == "GAS"
                          else u.liquid_rate)
            w.inj_rate = _opt_rate(item(r, 4, None), rate_scale)
            w.resv_rate = _opt_rate(item(r, 5, None), u.reservoir_rate)
            bhp = item(r, 6, None)
            w.bhp_limit = (bhp * u.pressure if bhp is not None
                           else 6895e4)  # ECL default ~1e4 psia
            thp = item(r, 7, None)
            w.thp_limit = thp * u.pressure if thp is not None else None
            vfp = item(r, 8, None)
            w.vfp_table = int(vfp) if vfp else None
    elif kw.name == "LIFTOPT":
        r = kw.records[0] if kw.records else []
        liftopt["increment"] = float(item(r, 0, 12500.0))
        liftopt["min_gradient"] = float(item(r, 1, 0.0))
        liftopt["interval_days"] = float(item(r, 2, 0.0))
    elif kw.name == "WLIFTOPT":
        for r in kw.records:
            w = wells[str(item(r, 0, ""))]
            w.glift_on = str(item(r, 1, "NO")).upper().startswith("Y")
            mx = item(r, 2, None)
            w.glift_max_alq = float(mx) if mx is not None else None
            w.glift_weight = float(item(r, 3, 1.0))
            w.glift_min_alq = float(item(r, 4, 0.0))
            w.glift_gas_weight = float(item(r, 5, 0.0))
    elif kw.name == "GLIFTOPT":
        for r in kw.records:
            g = str(item(r, 0, ""))
            mx = item(r, 1, None)
            liftopt.setdefault("groups", {})[g] = {
                "max_lift_gas": float(mx) if mx is not None else None,
            }
    elif kw.name == "WPOLYMER":
        for r in kw.records:
            w = wells[str(item(r, 0, ""))]
            w.poly_conc = float(item(r, 1, 0.0)) * u.polymer_concentration
            w.salt_conc = float(item(r, 2, 0.0)) * u.polymer_concentration
    elif kw.name == "WSALT":
        for r in kw.records:
            w = wells[str(item(r, 0, ""))]
            w.salt_conc = float(item(r, 1, 0.0)) * u.polymer_concentration
    elif kw.name == "WFOAM":
        for r in kw.records:
            w = wells[str(item(r, 0, ""))]
            w.foam_conc = float(item(r, 1, 0.0)) * u.polymer_concentration
    elif kw.name == "WRFTPLT":
        for r in kw.records:
            w = wells.get(str(item(r, 0, "")))
            if w is not None:
                w.rft = str(item(r, 1, "YES")).upper().startswith("Y")
    elif kw.name == "WELPI":
        for r in kw.records:
            w = wells.get(str(item(r, 0, "")))
            if w is not None:
                v = item(r, 1, None)
                if v is not None:
                    w.welpi_target = (float(v) * u.liquid_rate
                                      / u.pressure)
    elif kw.name == "WPIMULT":
        # reference: WellProdIndexCalculator WELPI/WPIMULT rescaling
        for r in kw.records:
            w = wells.get(str(item(r, 0, "")))
            if w is None:
                continue
            f = float(item(r, 1, 1.0))
            i = item(r, 2, None)
            j = item(r, 3, None)
            k1 = item(r, 4, None)
            k2 = item(r, 5, None)
            for c in w.completions:
                if i is not None and c.i != int(i) - 1:
                    continue
                if j is not None and c.j != int(j) - 1:
                    continue
                if k1 is not None and c.k < int(k1) - 1:
                    continue
                if k2 is not None and c.k > int(k2) - 1:
                    continue
                c.pi_mult *= f
    elif kw.name == "WEFAC":
        for r in kw.records:
            w = wells.get(str(item(r, 0, "")))
            if w is not None:
                w.efac = float(item(r, 1, 1.0))
    elif kw.name == "GEFAC":
        # group property, applied at snapshot time (so wells added to
        # the group AFTER the GEFAC record still inherit it — reference:
        # Group::getGroupEfficiencyFactor consumed per use, not parse)
        for r in kw.records:
            g = str(item(r, 0, ""))
            group_aux.setdefault("gefac", {})[g] = float(item(r, 1, 1.0))
    elif kw.name == "WSOLVENT":
        for r in kw.records:
            w = wells[str(item(r, 0, ""))]
            w.solv_frac = float(item(r, 1, 0.0))
    elif kw.name in ("WTEMP", "WINJTEMP"):
        for r in kw.records:
            w = wells[str(item(r, 0, ""))]
            idx = 1 if kw.name == "WTEMP" else 2
            t = item(r, idx, None)
            if t is not None:
                w.temp_inj = (float(t) * u.temperature_scale
                              + u.temperature_offset)
    elif kw.name == "GRUPTREE":
        for r in kw.records:
            child = str(item(r, 0, ""))
            parent = str(item(r, 1, "FIELD"))
            group_tree[child] = parent
    elif kw.name == "GUIDERAT" and group_aux is not None:
        # potential-based guide-rate formula
        # GR = POT^A / (B + C*R1^D + E*R2^F), R1 = water cut,
        # R2 = GOR of the potentials (Eclipse GUIDERAT; reference:
        # opm-common GuideRateModel consumed by WellGroupHelpers
        # updateGuideRates, WellGroupHelpers.hpp:104)
        r = kw.records[0] if kw.records else []
        group_aux["guiderat"] = {
            "interval_days": float(item(r, 0, 0.0)),
            "phase": str(item(r, 1, "NONE")).upper(),
            "a": float(item(r, 2, 0.0)),
            "b": float(item(r, 3, 0.0)),
            "c": float(item(r, 4, 0.0)),
            "d": float(item(r, 5, 0.0)),
            "e": float(item(r, 6, 0.0)),
            "f": float(item(r, 7, 0.0)),
            "allow_increase": str(item(r, 8, "YES")).upper() != "NO",
            "damping": float(item(r, 9, 1.0)),
        }
    elif kw.name == "WGRUPCON" and group_aux is not None:
        # per-well group-control availability + fixed guide rates
        for r in kw.records:
            pat = str(item(r, 0, ""))
            for wname, w in wells.items():
                if not _well_match(pat, wname):
                    continue
                gr = item(r, 2, None)
                group_aux.setdefault("wgrupcon", {})[wname] = {
                    "available": str(item(r, 1, "YES")).upper() != "NO",
                    "guide_rate": (float(gr) if gr is not None
                                   and float(gr) >= 0 else None),
                    "phase": str(item(r, 3, "OIL")).upper(),
                    "scaling": float(item(r, 4, 1.0)),
                }
    elif kw.name == "GCONPROD":
        for r in kw.records:
            g = str(item(r, 0, ""))
            group_prod[g] = {
                "mode": str(item(r, 1, "NONE")).upper(),
                "orat": _opt_rate(item(r, 2, None), u.liquid_rate),
                "wrat": _opt_rate(item(r, 3, None), u.liquid_rate),
                "grat": _opt_rate(item(r, 4, None), u.gas_rate),
                "lrat": _opt_rate(item(r, 5, None), u.liquid_rate),
                "resv": _opt_rate(item(r, 6, None), u.reservoir_rate),
            }
    elif kw.name == "GCONINJE":
        for r in kw.records:
            g = str(item(r, 0, ""))
            group_inj.setdefault(g, {})[
                str(item(r, 1, "GAS")).upper()] = {
                "mode": str(item(r, 2, "RATE")).upper(),
                "rate": _opt_rate(
                    item(r, 3, None),
                    u.gas_rate if str(item(r, 1, "GAS")).upper() == "GAS"
                    else u.liquid_rate),
                "resv": _opt_rate(item(r, 4, None), u.reservoir_rate),
                # REIN (reinjection) / VREP (voidage replacement)
                # fractions — reference: WellGroupHelpers REIN/VREP
                # target computation
                "rein_frac": (float(item(r, 5, 1.0))
                              if item(r, 5, None) is not None else 1.0),
                "vrep_frac": (float(item(r, 6, 1.0))
                              if item(r, 6, None) is not None else 1.0),
            }
    elif kw.name == "GRUPNET":
        # standard network model: per-group node with a fixed terminal
        # pressure or a VFP branch table to its parent node (reference:
        # Schedule's Network consumed by BlackoilWellModelGeneric network
        # balancing)
        if group_net is None:
            group_net = {}
        for r in kw.records:
            g = str(item(r, 0, ""))
            pr = item(r, 1, None)
            vfp = item(r, 2, 0)
            alq = item(r, 3, 0.0)
            group_net[g] = {
                "pressure": (float(pr) * u.pressure
                             if pr is not None and float(pr) >= 0 else None),
                "vfp": int(vfp) if vfp is not None else 0,
                "alq": float(alq) if alq is not None else 0.0,
            }
    elif kw.name == "NETBALAN":
        if group_net is None:
            group_net = {}
        r = kw.records[0] if kw.records else []
        group_net["_balan"] = {
            "interval_days": float(item(r, 0, 0.0)) * u.time / U.DAY,
            "ptol": float(item(r, 1, 1.0e-5)) * u.pressure,
            "max_iter": int(item(r, 2, 10)),
        }
    elif kw.name == "COMPLUMP":
        # assign completion (lump) numbers to connections; WELOPEN can
        # then open/shut whole lumps (the reference gets this from
        # opm-common's Schedule; used by Norne-class decks)
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells.get(name)
            if w is None:
                continue
            ii = int(item(r, 1, 0))
            jj = int(item(r, 2, 0))
            kk1 = int(item(r, 3, 0))
            kk2 = int(item(r, 4, kk1))
            n = int(item(r, 5, 0))
            for c in w.completions:
                if ii > 0 and c.i != ii - 1:
                    continue
                if jj > 0 and c.j != jj - 1:
                    continue
                if kk1 > 0 and not (kk1 - 1 <= c.k <= kk2 - 1):
                    continue
                c.lump = n
    elif kw.name == "WELOPEN":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells.get(name)
            if w is None:
                continue
            stat = str(item(r, 1, "OPEN")).upper()
            ii = int(item(r, 2, 0) or 0)
            jj = int(item(r, 3, 0) or 0)
            kk = int(item(r, 4, 0) or 0)
            c1 = int(item(r, 5, 0) or 0)
            c2 = int(item(r, 6, c1) or c1)
            if ii <= 0 and jj <= 0 and kk <= 0 and c1 <= 0:
                w.status = stat  # whole-well form
                continue
            # connection form: filter by location and/or lump range
            for c in w.completions:
                if ii > 0 and c.i != ii - 1:
                    continue
                if jj > 0 and c.j != jj - 1:
                    continue
                if kk > 0 and c.k != kk - 1:
                    continue
                if c1 > 0 and not (c1 <= c.lump <= c2):
                    continue
                c.open = stat == "OPEN"
    elif kw.name == "WTEST":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells.get(name)
            if w is not None:
                iv = item(r, 1, 0.0)
                w.wtest_interval = float(iv) * u.time / U.DAY if iv else None
    elif kw.name == "WECON":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells.get(name)
            if w is not None:
                # WECON items (0-based): 1 min oil rate, 2 min gas
                # rate, 3 max water cut, 4 max GOR, 5 max WGR,
                # 6 workover procedure (NONE/CON/+CON/WELL)
                w.econ_min_oil = _opt_rate(item(r, 1, None),
                                           u.liquid_rate)
                w.econ_min_gas = _opt_rate(item(r, 2, None), u.gas_rate)
                w.econ_max_wct = item(r, 3, None)
                w.econ_max_gor = _opt_rate(item(r, 4, None),
                                           u.gas_oil_ratio)
                w.econ_max_wgr = _opt_rate(item(r, 5, None),
                                           1.0 / u.gas_oil_ratio)
                w.econ_workover = str(item(r, 6, "NONE")).upper()
    elif kw.name == "WELTARG":
        for r in kw.records:
            name = str(item(r, 0, ""))
            w = wells.get(name)
            if w is None:
                continue
            quantity = str(item(r, 1, "ORAT")).upper()
            val = item(r, 2, 0.0)
            if quantity == "ORAT":
                w.oil_rate = val * u.liquid_rate
            elif quantity == "WRAT":
                w.water_rate = val * u.liquid_rate
            elif quantity == "GRAT":
                w.gas_rate = val * u.gas_rate
            elif quantity == "LRAT":
                w.liquid_rate = val * u.liquid_rate
            elif quantity == "BHP":
                w.bhp_limit = val * u.pressure
            elif quantity == "RATE":
                w.inj_rate = val * (u.gas_rate if w.inj_phase == "GAS"
                                    else u.liquid_rate)
    else:
        return False
    return True


def _build_schedule(deck: Deck, rs: Runspec, grid: GridSection) -> Schedule:
    u = rs.unit_system
    nx, ny, nz = rs.cartdims
    wells: dict[str, WellConfig] = {}
    steps: list[ReportStep] = []
    t_days = 0.0
    in_schedule = False
    current_date = rs.start

    group_tree: dict = {}
    group_prod: dict = {}
    group_inj: dict = {}
    group_net: dict = {}
    group_aux: dict = {}  # GUIDERAT formula + WGRUPCON per-well entries
    liftopt: dict = {}
    tuning: dict = {}

    def snapshot():
        # effective efficiency = WEFAC * product of GEFACs up the
        # group tree (reference: WellGroupHelpers accumulates group
        # efficiency along the chain)
        gefac = group_aux.get("gefac", {})

        def eff(w):
            e, grp, seen = w.efac, w.group, set()
            while grp and grp not in seen:
                seen.add(grp)
                e *= gefac.get(grp, 1.0)
                grp = group_tree.get(grp, "")
            return e

        return [dataclasses.replace(
            w, efac=eff(w),
            completions=[dataclasses.replace(c) for c in w.completions])
            for w in wells.values()]

    def group_snapshot():
        import copy
        return {"tree": dict(group_tree),
                "prod": copy.deepcopy(group_prod),
                "inj": copy.deepcopy(group_inj),
                "net": copy.deepcopy(group_net),
                "guiderat": copy.deepcopy(group_aux.get("guiderat")),
                "wgrupcon": copy.deepcopy(group_aux.get("wgrupcon", {}))}

    def advance(days: float):
        nonlocal t_days
        import copy
        steps.append(ReportStep(t_days, t_days + days, snapshot(),
                                group_snapshot(),
                                liftopt=copy.deepcopy(liftopt),
                                tuning=dict(tuning)))
        t_days += days

    dirty = False  # schedule mutations not yet captured by a ReportStep
    for kw in deck:
        if kw.name == "SCHEDULE":
            in_schedule = True
            continue
        if not in_schedule:
            continue
        if _apply_sched_keyword(kw, u, wells, group_tree, group_prod,
                                 group_inj, liftopt, group_net, group_aux):
            dirty = True
        elif kw.name in ("DRSDT", "DRVDT"):
            # max dissolved-GOR / vaporized-OGR increase rate
            # (reference: EclProblem::updateCompositionChangeLimits_,
            # eclproblem.hh:2010)
            r = kw.records[0] if kw.records else []
            v = item(r, 0, None)
            if v is not None:
                scale = ((u.gas_oil_ratio if kw.name == "DRSDT"
                          else u.oil_gas_ratio) / u.time)
                tuning[kw.name.lower()] = float(v) * scale
        elif kw.name == "TUNING":
            # record 1: TSINIT TSMAXZ TSMINZ ... (days); reference:
            # AdaptiveTimeSteppingEbos::updateTUNING
            r = kw.records[0] if kw.records else []
            ts_init = item(r, 0, None)
            ts_max = item(r, 1, None)
            ts_min = item(r, 2, None)
            if ts_init is not None:
                tuning["initial_dt_days"] = float(ts_init) * u.time / U.DAY
            if ts_max is not None:
                tuning["max_dt_days"] = float(ts_max) * u.time / U.DAY
            if ts_min is not None:
                tuning["min_dt_days"] = float(ts_min) * u.time / U.DAY
            # items 5/6: TSFMAX max dt growth factor, TSFMIN chop
            # factor after a failed substep (dimensionless)
            tsfmax = item(r, 4, None)
            tsfmin = item(r, 5, None)
            if tsfmax is not None:
                tuning["growth_factor"] = float(tsfmax)
            if tsfmin is not None:
                tuning["restart_factor"] = float(tsfmin)
        elif kw.name == "TSTEP":
            for v in kw.records[0]:
                if v is not DEFAULT:
                    advance(float(v) * u.time / U.DAY)
            dirty = False
        elif kw.name == "DATES":
            for r in kw.records:
                day = int(item(r, 0, 1))
                mon = MONTHS.get(str(item(r, 1, "JAN")).upper(), 1)
                year = int(item(r, 2, current_date.year))
                new_date = datetime.date(year, mon, day)
                base = rs.start
                new_days = (new_date - base).days
                if new_days > t_days:
                    advance(new_days - t_days)
                    dirty = False
                current_date = new_date
    if dirty and steps:
        # Schedule keywords after the final TSTEP/DATES: the reference
        # Schedule keeps nsteps+1 states, so e.g. a trailing WELOPEN is
        # observable at the last report index (test_stoppedwells.cpp:54
        # checks getWells(1) after one TSTEP). Capture it as a
        # zero-length trailing step — the substep loop runs no substeps
        # for it (timestepper.py run_report_step: step_days == 0).
        advance(0.0)
    return Schedule(steps)


def _opt_rate(v, scale):
    return float(v) * scale if v is not None else None


def build_state(deck: Deck) -> EclState:
    rs = _build_runspec(deck)
    grid = _build_grid(deck, rs)
    n = len(grid.poro)
    props = _build_props(deck, rs)
    solution = _build_solution(deck, rs, n)
    summary = _build_summary(deck)
    schedule = _build_schedule(deck, rs, grid)
    n = len(grid.poro)
    regions = {}
    for name in ("SATNUM", "PVTNUM", "EQLNUM", "FIPNUM", "IMBNUM"):
        arr = _grid_array(deck, name, n, dtype=int)
        if arr is not None:
            regions[name] = arr
    aquifers = {}
    for name in ("AQUCT", "AQUFETP", "AQUANCON", "AQUNUM", "AQUCON"):
        kws = deck.get(name)
        if kws:
            aquifers[name] = [r for kw in kws for r in kw.records]
    tracers = {}
    for name in ("TRACER", "WTRACER"):
        kws = deck.get(name)
        if kws:
            tracers[name] = [r for kw in kws for r in kw.records]
    for kw in deck:
        if kw.name.startswith("TBLKF"):
            tracers[kw.name] = [v for v in kw.records[0] if v is not DEFAULT]
    eps_arrays = {}
    nc = len(grid.poro)
    for name in ("SWL", "SWCR", "SWU", "SGL", "SGCR", "SGU", "SOWCR",
                 "SOGCR", "KRW", "KRO", "KRG", "PCW", "PCG", "SWATINIT"):
        arr = _grid_array(deck, name, nc)
        if arr is not None:
            eps_arrays[name] = arr
    # depth-interpolated end points (reference: satfuncEPS_B.DATA +
    # opm-common EclEpsGridProperties ENPTVD/ENKRVD): one table per
    # endpoint-table region; defaulted columns stay NaN ("no scaling").
    #   ENPTVD: depth swl swcr swu sgl sgcr sgu sowcr sogcr  (9 cols)
    #   ENKRVD: depth krw  krg  kro krwr krgr krorw krorg    (8 cols)
    u_eps = rs.unit_system
    for name, ncol in (("ENPTVD", 9), ("ENKRVD", 8)):
        kw = deck.get1(name)
        if kw and kw.records and kw.records[0]:
            vals = np.asarray(
                [np.nan if v is DEFAULT else float(v)
                 for v in kw.records[0]], float)
            if vals.size % ncol == 0 and vals.size:
                t = vals.reshape(-1, ncol)
                t[:, 0] *= u_eps.length
                eps_arrays[name] = t
    components = {}
    u = rs.unit_system
    cscale = u.polymer_concentration
    kw = deck.get1("PLYVISC")
    if kw:
        t = _table_2d_regions(kw, 2, [cscale, 1.0])
        components["PLYVISC"] = t
    kw = deck.get1("PLYADS")
    if kw:
        # conc -> adsorbed mass per mass rock (dimensionless mass ratio)
        components["PLYADS"] = _table_2d_regions(kw, 2, [cscale, 1.0])
    kw = deck.get1("PLYROCK")
    if kw:
        recs = []
        for r in kw.records:
            recs.append({
                "dead_pore": float(item(r, 0, 0.0)),
                "rrf": float(item(r, 1, 1.0)),
                "rock_density": float(item(r, 2, 0.0))
                * u.mass / u.reservoir_volume,
                "ads_index": int(item(r, 3, 1)),
                "max_ads": float(item(r, 4, 0.0)),
            })
        components["PLYROCK"] = recs
    kw = deck.get1("PLYMAX")
    if kw and kw.records:
        components["PLYMAX"] = float(item(kw.records[0], 0, 0.0)) * cscale
    kw = deck.get1("FOAMMOB")
    if kw:
        components["FOAMMOB"] = _table_2d_regions(kw, 2, [cscale, 1.0])
    kw = deck.get1("PVTWSALT")
    if kw and len(kw.records) >= 2:
        hdr = kw.records[0]
        rows = [v for v in kw.records[1] if v is not DEFAULT]
        tab = np.asarray(rows, float).reshape(-1, 5)
        tab[:, 0] *= cscale            # salt concentration
        tab[:, 1] *= u.oil_fvf         # Bw
        tab[:, 2] *= u.compressibility
        tab[:, 3] *= u.viscosity
        tab[:, 4] *= u.compressibility
        components["PVTWSALT"] = {
            "p_ref": float(item(hdr, 0, 1.0)) * u.pressure,
            "salt_ref": float(item(hdr, 1, 0.0)) * cscale,
            "table": tab,
        }
    kw = deck.get1("SALTVD")
    if kw:
        components["SALTVD"] = _table_2d_regions(
            kw, 2, [u.length, cscale])
    kw = deck.get1("TEMPVD")
    if kw:
        # temperature vs depth (deck temperature units; the thermal
        # model converts to K)
        components["TEMPVD"] = _table_2d_regions(kw, 2, [u.length, 1.0])
    kw = deck.get1("PVDS")
    if kw:
        components["PVDS"] = _table_2d_regions(
            kw, 3, [u.pressure, u.gas_fvf, u.viscosity])
    kw = deck.get1("TLMIXPAR")
    if kw and kw.records:
        components["TLMIXPAR"] = float(item(kw.records[0], 0, 1.0))
    kw = deck.get1("PVTSOL")
    if kw:
        # extended-black-oil composition tables (models/extbo.py schema:
        # each record is one z-composition branch — z then rows of
        # p Bo Bg Rs Rv XVOL YVOL mu_o mu_g; empty record closes a
        # PVTNUM region, like PVTO's branch layout)
        sol_regions = []
        z_list, branches = [], []
        scale = [u.pressure, u.oil_fvf, u.gas_fvf, u.gas_oil_ratio,
                 u.oil_gas_ratio, 1.0, 1.0, u.viscosity, u.viscosity]
        for rec in kw.records:
            vals = [v for v in rec if v is not DEFAULT]
            if not vals:
                if z_list:
                    sol_regions.append({"z": np.asarray(z_list),
                                        "branches": branches})
                    z_list, branches = [], []
                elif sol_regions:
                    sol_regions.append(sol_regions[-1])
                continue
            z = float(vals[0])
            rest = np.asarray(vals[1:], float).reshape(-1, 9)
            cols = tuple(rest[:, i] * scale[i] for i in range(9))
            z_list.append(z)
            branches.append(cols)
        if z_list:
            sol_regions.append({"z": np.asarray(z_list),
                                "branches": branches})
        components["PVTSOL"] = sol_regions
    # miscible-solvent tables (reference: opm-material
    # blackoilsolventmodules' MISC/PMISC/SSFN handling under MISCIBLE)
    kw = deck.get1("MISC")
    if kw:
        components["MISC"] = _table_2d_regions(kw, 2, [1.0, 1.0])
    kw = deck.get1("PMISC")
    if kw:
        components["PMISC"] = _table_2d_regions(kw, 2, [u.pressure, 1.0])
    kw = deck.get1("SSFN")
    if kw:
        components["SSFN"] = _table_2d_regions(kw, 3, [1.0, 1.0, 1.0])
    kw = deck.get1("MSFN")
    if kw:
        components["MSFN"] = _table_2d_regions(kw, 3, [1.0, 1.0, 1.0])
    kw = deck.get1("SORWMIS")
    if kw:
        components["SORWMIS"] = _table_2d_regions(kw, 2, [1.0, 1.0])
    kw = deck.get1("SGCWMIS")
    if kw:
        components["SGCWMIS"] = _table_2d_regions(kw, 2, [1.0, 1.0])
    # thermal property tables (energy variant; reference
    # flow_ebos_energy.cpp + opm-material thermal laws)
    kw = deck.get1("SPECROCK")
    if kw:
        # rock volumetric heat capacity: energy / (rock volume * deg);
        # temperature axes stay in DECK degrees (the thermal model adds
        # the offset — multiplicative scaling can't express deg F -> K)
        components["SPECROCK"] = _table_2d_regions(
            kw, 2, [1.0,
                    u.energy / (u.length ** 3 * u.temperature_scale)])
    kw = deck.get1("SPECHEAT")
    if kw:
        # fluid specific heats (oil, water, gas): energy / (mass * deg)
        ch = u.energy / (u.mass * u.temperature_scale)
        components["SPECHEAT"] = _table_2d_regions(
            kw, 4, [1.0, ch, ch, ch])
    for nm in ("WATVISCT", "OILVISCT", "GASVISCT"):
        kw = deck.get1(nm)
        if kw:
            components[nm] = _table_2d_regions(
                kw, 2, [1.0, u.viscosity])
    arr = _grid_array(deck, "TEMPI", nc)
    if arr is not None:
        components["TEMPI"] = arr
    arr = _grid_array(deck, "THCONR", nc)
    if arr is not None:
        components["THCONR"] = arr
    kw = deck.get1("VISCREF")
    if kw and kw.records:
        components["VISCREF"] = [
            (item(r, 0, 1.0) * u.pressure, item(r, 1, None))
            for r in kw.records if r]
    vfp_prod = [kw.records for kw in deck.get("VFPPROD")]
    vfp_inj = [kw.records for kw in deck.get("VFPINJ")]
    nnc = []
    for kw in deck.get("NNC"):
        for r in kw.records:
            nnc.append(((int(item(r, 0, 1)) - 1, int(item(r, 1, 1)) - 1,
                         int(item(r, 2, 1)) - 1),
                        (int(item(r, 3, 1)) - 1, int(item(r, 4, 1)) - 1,
                         int(item(r, 5, 1)) - 1),
                        float(item(r, 6, 0.0)) * u.transmissibility))
    faults: dict = {}
    for kw in deck.get("FAULTS"):
        for r in kw.records:
            if not r:
                continue
            name = str(item(r, 0, "")).upper()
            faults.setdefault(name, []).append((
                int(item(r, 1, 1)) - 1, int(item(r, 2, 1)) - 1,
                int(item(r, 3, 1)) - 1, int(item(r, 4, 1)) - 1,
                int(item(r, 5, 1)) - 1, int(item(r, 6, 1)) - 1,
                str(item(r, 7, "X")).upper()))
    multflt: dict = {}
    for kw in deck.get("MULTFLT"):
        for r in kw.records:
            if not r:
                continue
            name = str(item(r, 0, "")).upper()
            # repeated records compose multiplicatively (ECLIPSE
            # MULTFLT semantics within one keyword occurrence set)
            multflt[name] = multflt.get(name, 1.0) * float(item(r, 1, 1.0))
    editnnc = []
    for kw in deck.get("EDITNNC"):
        for r in kw.records:
            editnnc.append(((int(item(r, 0, 1)) - 1, int(item(r, 1, 1)) - 1,
                             int(item(r, 2, 1)) - 1),
                            (int(item(r, 3, 1)) - 1, int(item(r, 4, 1)) - 1,
                             int(item(r, 5, 1)) - 1),
                            float(item(r, 6, 1.0))))
    thpres = []
    for kw in deck.get("THPRES"):
        for r in kw.records:
            thpres.append((int(item(r, 0, 1)), int(item(r, 1, 1)),
                           item(r, 2, None) and
                           float(item(r, 2, 0.0)) * u.pressure))
    props = _synthesize_satfam(props, rs.phases)
    return EclState(rs, grid, props, regions, solution, summary, schedule,
                    aquifers=aquifers, tracers=tracers,
                    components=components, eps_arrays=eps_arrays,
                    udq_keywords=deck.get("UDQ"),
                    action_keywords=deck.get("ACTIONX"),
                    vfp_prod_records=vfp_prod, vfp_inj_records=vfp_inj,
                    nnc=nnc, editnnc=editnnc, thpres=thpres,
                    faults=faults, multflt=multflt,
                    flags=frozenset(
                        k for k in ("PINCH", "EHYSTR")
                        if deck.get1(k) is not None),
                    ehystr=((float(item(deck.get1("EHYSTR").records[0],
                                        0, 0.1) or 0.1),
                             int(item(deck.get1("EHYSTR").records[0],
                                      1, 2) or 2))
                            if deck.get1("EHYSTR") is not None
                            else (0.1, 2)))


def load_state(path: str) -> EclState:
    import os

    deck = read_deck(path)
    st = build_state(deck)
    from opm_autodiff_tpu_torch.io.validation import validate_deck
    st.validation = validate_deck(deck)
    st.deck_dir = os.path.dirname(os.path.abspath(path))
    return st

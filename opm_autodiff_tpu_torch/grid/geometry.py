"""Grid geometry, active-cell compression, face topology, transmissibility.

Host-side numpy copy of the reference package's geometry builder: the
reference's CpGrid + per-element intersection loops (reference:
ebos/ecltransmissibility.cc:146 ``EclTransmissibility::update``) become
**static flat arrays built once on the host**: compressed cell arrays
plus a face list ``(left, right, trans, dz)``. The topology never changes
during a run, so the device side sees fixed shapes.

Cartesian (DX/DY/DZ/TOPS) grids build here; COORD/ZCORN decks are not
ported yet and raise (ROADMAP.md Queue 1 item 9).

Transmissibility semantics mirror ecltransmissibility.cc:
  half-trans per cell/axis  T_h = k_axis * A_eff / d_half
  face trans                T   = MULT+ * MULT- / (1/T_h,l + 1/T_h,r)
with NTG applied to X/Y areas only (reference: applyNtg_), and MULTX/Y/Z
applied from the cell on the negative side of the face, MULTX-/Y-/Z- from
the positive side.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from opm_autodiff_tpu_torch.io.state import EclState, GridSection


@dataclasses.dataclass
class FaceList:
    """Interior connections between active cells (compressed indices)."""

    left: np.ndarray   # [nf] int32, cell on the negative side
    right: np.ndarray  # [nf] int32, cell on the positive side
    trans: np.ndarray  # [nf] f64, SI (m^3)
    axis: np.ndarray   # [nf] int8: 0=X, 1=Y, 2=Z, 3=NNC
    thpres: np.ndarray | None = None  # [nf] threshold pressure (Pa)
    # thermal half-transmissibilities A/d [m] of the left/right halves
    # (reference: ecltransmissibility.cc thermalHalfTrans_ — geometric
    # only, no permeability or MULT*; the energy module multiplies by
    # each cell's THCONR and combines harmonically). None on layouts
    # that have not been extended (models/thermal.py then falls back to
    # the trans/k_face approximation).
    th_left: np.ndarray | None = None
    th_right: np.ndarray | None = None

    @property
    def num_faces(self) -> int:
        return len(self.left)


@dataclasses.dataclass
class Geometry:
    cartdims: tuple[int, int, int]
    num_active: int
    # mapping between natural (cartesian) and compressed (active) indices
    glob_to_act: np.ndarray  # [nx*ny*nz] int32, -1 for inactive
    act_to_glob: np.ndarray  # [na] int32
    # per-active-cell properties (SI)
    volume: np.ndarray       # bulk volume [m^3]
    pore_vol: np.ndarray     # reference pore volume (incl NTG, MULTPV) [m^3]
    depth: np.ndarray        # cell-center depth, positive down [m]
    dx: np.ndarray
    dy: np.ndarray
    dz: np.ndarray
    permx: np.ndarray
    permy: np.ndarray
    permz: np.ndarray
    poro: np.ndarray
    ntg: np.ndarray
    faces: FaceList
    satnum: np.ndarray | None = None  # [na] zero-based SATNUM region
    pvtnum: np.ndarray | None = None  # [na] zero-based PVTNUM region
    fipnum: np.ndarray | None = None  # [na] zero-based FIPNUM region

    def ijk(self, act_index: int) -> tuple[int, int, int]:
        nx, ny, _ = self.cartdims
        g = int(self.act_to_glob[act_index])
        return (g % nx, (g // nx) % ny, g // (nx * ny))

    def act_index(self, i: int, j: int, k: int) -> int:
        nx, ny, _ = self.cartdims
        return int(self.glob_to_act[i + nx * (j + ny * k)])


def _half_trans(perm, area, dist):
    with np.errstate(divide="ignore"):
        return np.where(dist > 0, perm * area / np.maximum(dist, 1e-300), 0.0)


def build_geometry(state: EclState) -> Geometry:
    g: GridSection = state.grid
    if g.coord is not None and g.zcorn is not None:
        raise NotImplementedError(
            "corner-point (COORD/ZCORN) grids are not ported yet: "
            "ROADMAP.md Queue 1 item 9 (embedded banded layout)")
    nx, ny, nz = state.cartdims
    n = nx * ny * nz

    act_mask = g.actnum > 0
    glob_to_act = np.full(n, -1, np.int32)
    act_to_glob = np.nonzero(act_mask)[0].astype(np.int32)
    glob_to_act[act_to_glob] = np.arange(len(act_to_glob), dtype=np.int32)
    na = len(act_to_glob)

    def compress(a):
        return np.ascontiguousarray(a[act_to_glob])

    dx, dy, dz = compress(g.dx), compress(g.dy), compress(g.dz)
    volume = dx * dy * dz
    ntg = compress(g.ntg)
    pore_vol = volume * compress(g.poro) * ntg * compress(g.multpv)
    depth = compress(g.depth)
    permx, permy, permz = compress(g.permx), compress(g.permy), compress(g.permz)

    # --- half-transmissibilities per axis on the full cartesian grid ---
    # area includes NTG for X/Y (reference: applyNtg_, ecltransmissibility.cc)
    hx = _half_trans(g.permx, g.dy * g.dz * g.ntg, g.dx / 2)
    hy = _half_trans(g.permy, g.dx * g.dz * g.ntg, g.dy / 2)
    hz = _half_trans(g.permz, g.dx * g.dy, g.dz / 2)

    # thermal (geometric) half-transmissibilities A/d — no perm, no
    # MULT*, NTG on X/Y areas (reference: ecltransmissibility.cc
    # thermalHalfTrans_)
    with np.errstate(divide="ignore", invalid="ignore"):
        tx = np.nan_to_num(g.dy * g.dz * g.ntg / (g.dx / 2))
        ty = np.nan_to_num(g.dx * g.dz * g.ntg / (g.dy / 2))
        tz = np.nan_to_num(g.dx * g.dy / (g.dz / 2))

    shape = (nz, ny, nx)
    act3 = act_mask.reshape(shape)

    lefts, rights, transs, axes, th_ls, th_rs = [], [], [], [], [], []

    def add_faces(axis_id, h, th, mult_pos, mult_neg, np_axis):
        """Faces along numpy axis `np_axis` of the (nz,ny,nx) view."""
        h3 = h.reshape(shape)
        th3 = th.reshape(shape)
        mp3 = mult_pos.reshape(shape)
        mn3 = mult_neg.reshape(shape)
        sl_l = [slice(None)] * 3
        sl_r = [slice(None)] * 3
        sl_l[np_axis] = slice(0, -1)
        sl_r[np_axis] = slice(1, None)
        sl_l, sl_r = tuple(sl_l), tuple(sl_r)
        both = act3[sl_l] & act3[sl_r]
        hl, hr = h3[sl_l][both], h3[sl_r][both]
        with np.errstate(divide="ignore"):
            t = np.where((hl > 0) & (hr > 0), hl * hr / np.maximum(hl + hr, 1e-300), 0.0)
        t = t * mp3[sl_l][both] * mn3[sl_r][both]
        gid = np.arange(n).reshape(shape)
        gl = gid[sl_l][both]
        gr = gid[sl_r][both]
        keep = t > 0.0
        lefts.append(glob_to_act[gl[keep]])
        rights.append(glob_to_act[gr[keep]])
        transs.append(t[keep])
        axes.append(np.full(keep.sum(), axis_id, np.int8))
        th_ls.append(th3[sl_l][both][keep])
        th_rs.append(th3[sl_r][both][keep])

    ones = np.ones(n)
    # MULT*- : the RIGHT cell's negative-direction multiplier applies
    # to the same face as the LEFT cell's positive one (reference:
    # applyAllZMultipliers_/ multiplier handling, ecltransmissibility.cc)
    mxm = g.multxm if g.multxm is not None else ones
    mym = g.multym if g.multym is not None else ones
    mzm = g.multzm if g.multzm is not None else ones
    add_faces(0, hx, tx, g.multx, mxm, 2)  # X neighbors: last numpy axis
    add_faces(1, hy, ty, g.multy, mym, 1)
    add_faces(2, hz, tz, g.multz, mzm, 0)

    faces = FaceList(
        left=np.concatenate(lefts).astype(np.int32),
        right=np.concatenate(rights).astype(np.int32),
        trans=np.concatenate(transs),
        axis=np.concatenate(axes),
        th_left=np.concatenate(th_ls),
        th_right=np.concatenate(th_rs),
    )
    if "PINCH" in getattr(state, "flags", ()):
        faces = _append_pinch(faces, act3, hz.reshape(shape),
                              glob_to_act, (nx, ny, nz))
    faces = append_nnc(faces, state, glob_to_act, (nx, ny))
    apply_multflt(faces, state, glob_to_act, (nx, ny))
    apply_editnnc(faces, state, glob_to_act, (nx, ny))
    faces = _apply_numerical_aquifers(state, glob_to_act, (nx, ny),
                                      pore_vol, depth, volume, permx,
                                      dx, dy, dz, faces)
    compute_face_thpres(faces, state, act_to_glob)

    satnum = state.regions.get("SATNUM")
    satnum_c = (np.maximum(satnum[act_to_glob] - 1, 0).astype(np.int32)
                if satnum is not None else np.zeros(na, np.int32))
    pvtnum = state.regions.get("PVTNUM")
    pvtnum_c = (np.maximum(pvtnum[act_to_glob] - 1, 0).astype(np.int32)
                if pvtnum is not None else np.zeros(na, np.int32))
    fipnum = state.regions.get("FIPNUM")
    fipnum_c = (np.maximum(fipnum[act_to_glob] - 1, 0).astype(np.int32)
                if fipnum is not None else np.zeros(na, np.int32))
    return Geometry(
        cartdims=(nx, ny, nz), num_active=na,
        glob_to_act=glob_to_act, act_to_glob=act_to_glob,
        volume=volume, pore_vol=pore_vol, depth=depth,
        dx=dx, dy=dy, dz=dz, permx=permx, permy=permy, permz=permz,
        poro=compress(g.poro), ntg=ntg, faces=faces, satnum=satnum_c,
        pvtnum=pvtnum_c, fipnum=fipnum_c,
    )


def _apply_numerical_aquifers(state, glob_to_act, nxy, pore_vol, depth,
                              volume, permx, dx, dy, dz, faces):
    """AQUNUM/AQUCON numerical aquifers (reference: AquiferNumerical,
    opm/simulators/aquifers/AquiferNumerical.hpp:32): AQUNUM turns grid
    cells into 1-D aquifer cells with their own bulk volume/porosity/
    perm/depth; AQUCON connects reservoir-cell box faces to the
    aquifer's first cell with a computed transmissibility.

    Mutates the per-cell arrays in place and returns the extended face
    list (aquifer connections are axis-3 faces, like NNCs)."""
    from opm_autodiff_tpu_torch.io.state import item

    aqunum = state.aquifers.get("AQUNUM")
    if not aqunum:
        return faces
    u = state.runspec.unit_system
    nx, ny = nxy
    # aquifer id -> (first cell act index, perm, length, area)
    first_cell = {}
    for r in aqunum:
        aq_id = int(item(r, 0, 1))
        i = int(item(r, 1, 1)) - 1
        j = int(item(r, 2, 1)) - 1
        k = int(item(r, 3, 1)) - 1
        c = glob_to_act[i + nx * (j + ny * k)]
        if c < 0:
            continue
        area = item(r, 4, None)
        length = item(r, 5, None)
        poro = item(r, 6, None)
        perm = item(r, 7, None)
        dep = item(r, 8, None)
        area = (area * u.length ** 2 if area is not None
                else dy[c] * dz[c])
        length = length * u.length if length is not None else dx[c]
        poro = poro if poro is not None else 0.25
        perm = (perm * u.permeability if perm is not None else permx[c])
        volume[c] = area * length
        pore_vol[c] = area * length * poro
        permx[c] = perm
        if dep is not None:
            depth[c] = dep * u.length
        if aq_id not in first_cell:
            first_cell[aq_id] = (int(c), perm, length, area)

    aqucon = state.aquifers.get("AQUCON") or []
    lefts, rights, transs = [], [], []
    for r in aqucon:
        aq_id = int(item(r, 0, 1))
        if aq_id not in first_cell:
            continue
        c_aq, k_aq, len_aq, area_aq = first_cell[aq_id]
        i1, i2 = int(item(r, 1, 1)) - 1, int(item(r, 2, 1)) - 1
        j1, j2 = int(item(r, 3, 1)) - 1, int(item(r, 4, 1)) - 1
        k1, k2 = int(item(r, 5, 1)) - 1, int(item(r, 6, 1)) - 1
        face = str(item(r, 7, "I-")).upper().strip("'")
        mult = item(r, 8, 1.0)
        for kk in range(k1, k2 + 1):
            for jj in range(j1, j2 + 1):
                for ii in range(i1, i2 + 1):
                    c = glob_to_act[ii + nx * (jj + ny * kk)]
                    if c < 0 or c == c_aq:
                        continue
                    if face.startswith("I"):
                        a_face = dy[c] * dz[c]
                        d_res = dx[c]
                    elif face.startswith("J"):
                        a_face = dx[c] * dz[c]
                        d_res = dy[c]
                    else:
                        a_face = dx[c] * dy[c]
                        d_res = dz[c]
                    h_res = permx[c] * a_face / (d_res / 2.0)
                    h_aq = k_aq * area_aq / (len_aq / 2.0)
                    t = mult * h_res * h_aq / max(h_res + h_aq, 1e-300)
                    if t > 0:
                        lefts.append(int(c_aq))
                        rights.append(int(c))
                        transs.append(t)
    if not lefts:
        return faces
    return FaceList(
        left=np.concatenate([faces.left, np.asarray(lefts, np.int32)]),
        right=np.concatenate([faces.right, np.asarray(rights, np.int32)]),
        trans=np.concatenate([faces.trans, np.asarray(transs)]),
        axis=np.concatenate([faces.axis,
                             np.full(len(lefts), 3, np.int8)]),
        # appended connections conduct no heat (zero thermal halves)
        th_left=(np.concatenate([faces.th_left, np.zeros(len(lefts))])
                 if faces.th_left is not None else None),
        th_right=(np.concatenate([faces.th_right, np.zeros(len(lefts))])
                  if faces.th_right is not None else None),
    )


def compute_face_thpres(faces: FaceList, state, geo_act_to_glob) -> None:
    """Fill faces.thpres from THPRES records + EQLNUM regions
    (reference: eclthresholdpressure.hh). Defaulted records enter as 0
    here and are filled from the equilibrated initial state by
    ``Simulator._apply_default_thpres`` (reference:
    eclgenericthresholdpressure.cc:194 computeDefaultThresholdPressures_)."""
    nf = len(faces.left)
    faces.thpres = np.zeros(nf)
    thpres = getattr(state, "thpres", None)
    eqlnum = state.regions.get("EQLNUM")
    if not thpres or eqlnum is None:
        return
    eql_act = eqlnum[geo_act_to_glob]
    table = {}
    for r1, r2, dp in thpres:
        if dp is None:
            dp = 0.0
        table[(r1, r2)] = dp
        table.setdefault((r2, r1), dp)
    rl = eql_act[faces.left]
    rr = eql_act[faces.right]
    for (r1, r2), dp in table.items():
        sel = (rl == r1) & (rr == r2)
        faces.thpres[sel] = dp


def _append_pinch(faces: FaceList, act3, hz3, glob_to_act,
                  dims) -> FaceList:
    """PINCH: connect active cells vertically across pinched-out
    (inactive) thin layers (reference: PINCH handling in the vanguard's
    transmissibility setup; default GAP/TOPBOT options). The connection
    carries the harmonic mean of the two active cells' z
    half-transmissibilities."""
    nx, ny, nz = dims
    lefts, rights, transs = [], [], []
    for j in range(ny):
        for i in range(nx):
            col = act3[:, j, i]
            ks = np.nonzero(col)[0]
            for a, b in zip(ks[:-1], ks[1:]):
                if b == a + 1:
                    continue  # adjacent: the normal z face exists
                hl, hr = hz3[a, j, i], hz3[b, j, i]
                if hl <= 0 or hr <= 0:
                    continue
                t = hl * hr / (hl + hr)
                ga = i + nx * (j + ny * a)
                gb = i + nx * (j + ny * b)
                lefts.append(glob_to_act[ga])
                rights.append(glob_to_act[gb])
                transs.append(t)
    if not lefts:
        return faces
    zeros = np.zeros(len(lefts))
    return FaceList(
        left=np.concatenate([faces.left,
                             np.asarray(lefts, np.int32)]),
        right=np.concatenate([faces.right,
                              np.asarray(rights, np.int32)]),
        trans=np.concatenate([faces.trans, np.asarray(transs)]),
        axis=np.concatenate([faces.axis,
                             np.full(len(lefts), 3, np.int8)]),
        th_left=(np.concatenate([faces.th_left, zeros])
                 if faces.th_left is not None else None),
        th_right=(np.concatenate([faces.th_right, zeros])
                  if faces.th_right is not None else None),
    )


def apply_multflt(faces: FaceList, state, glob_to_act, nxy) -> None:
    """MULTFLT: scale the faces of the named FAULTS face sets
    (reference: applyMultipliers via the FaultCollection,
    ecltransmissibility.cc). A FAULTS record names cell-face ranges
    ('X' = the face toward i+1, 'X-' = toward i-1, same for Y/Z); every
    matching interior connection is multiplied."""
    fault_defs = getattr(state, "faults", None)
    mults = getattr(state, "multflt", None)
    if not fault_defs or not mults:
        return
    import numpy as _np

    nx, ny = nxy
    nz_max = 10 ** 9
    pair_mult: dict = {}
    for name, m in mults.items():
        for (i1, i2, j1, j2, k1, k2, face) in fault_defs.get(name, []):
            ax = {"X": 0, "I": 0, "Y": 1, "J": 1, "Z": 2, "K": 2}[
                face.rstrip("-")]
            neg = face.endswith("-")
            step = {0: 1, 1: nx, 2: nx * ny}[ax]
            for k in range(max(k1, 0), min(k2, nz_max) + 1):
                for j in range(j1, j2 + 1):
                    for i in range(i1, i2 + 1):
                        g = i + nx * (j + ny * k)
                        ga, gb = (g - step, g) if neg else (g, g + step)
                        a = glob_to_act[ga] if 0 <= ga < len(glob_to_act) \
                            else -1
                        b = glob_to_act[gb] if 0 <= gb < len(glob_to_act) \
                            else -1
                        if a < 0 or b < 0:
                            continue
                        key = (min(a, b), max(a, b))
                        pair_mult[key] = pair_mult.get(key, 1.0) * m
    if not pair_mult:
        return
    lo = _np.minimum(faces.left, faces.right)
    hi = _np.maximum(faces.left, faces.right)
    for (a, b), m in pair_mult.items():
        sel = (lo == a) & (hi == b)
        if sel.any():
            faces.trans[sel] *= m


def apply_editnnc(faces: FaceList, state, glob_to_act, nxy) -> None:
    """EDITNNC transmissibility multipliers: scale any connection
    joining the two named cells — explicit NNC faces and generated
    cross-pillar/fault connections alike (reference:
    ecltransmissibility.cc applyEditNncToGridTrans_)."""
    edits = getattr(state, "editnnc", None)
    if not edits:
        return
    import numpy as _np

    nx, ny = nxy
    table: dict = {}
    for (i1, j1, k1), (i2, j2, k2), m in edits:
        a = glob_to_act[i1 + nx * (j1 + ny * k1)]
        b = glob_to_act[i2 + nx * (j2 + ny * k2)]
        if a < 0 or b < 0:
            continue
        key = (min(a, b), max(a, b))
        # repeated records accumulate multiplicatively (reference
        # EDITNNC semantics: each record scales the current value)
        table[key] = table.get(key, 1.0) * m
    if not table:
        return
    lo = _np.minimum(faces.left, faces.right)
    hi = _np.maximum(faces.left, faces.right)
    for (a, b), m in table.items():
        sel = (lo == a) & (hi == b)
        if sel.any():
            faces.trans[sel] *= m


def append_nnc(faces: FaceList, state, glob_to_act, nxy) -> FaceList:
    """Append explicit NNC keyword connections as axis-3 faces
    (reference: ecltransmissibility.cc:487 NNC application)."""
    if not getattr(state, "nnc", None):
        return faces
    nx, ny = nxy
    lefts, rights, transs = [], [], []
    for (i1, j1, k1), (i2, j2, k2), t in state.nnc:
        a = glob_to_act[i1 + nx * (j1 + ny * k1)]
        b = glob_to_act[i2 + nx * (j2 + ny * k2)]
        if a < 0 or b < 0 or t <= 0:
            continue
        lefts.append(a)
        rights.append(b)
        transs.append(t)
    if not lefts:
        return faces
    import numpy as _np

    return FaceList(
        left=_np.concatenate([faces.left,
                              _np.asarray(lefts, _np.int32)]),
        right=_np.concatenate([faces.right,
                               _np.asarray(rights, _np.int32)]),
        trans=_np.concatenate([faces.trans, _np.asarray(transs)]),
        axis=_np.concatenate([faces.axis,
                              _np.full(len(lefts), 3, _np.int8)]),
        th_left=(_np.concatenate([faces.th_left,
                                  _np.zeros(len(lefts))])
                 if faces.th_left is not None else None),
        th_right=(_np.concatenate([faces.th_right,
                                   _np.zeros(len(lefts))])
                  if faces.th_right is not None else None),
    )


def peaceman_well_index(geo: Geometry, act_cell: int, diameter: float,
                        skin: float, direction: str = "Z",
                        kh: float | None = None) -> float:
    """Peaceman connection transmissibility factor (SI, m^3).

    Reference semantics: WellProdIndexCalculator / the CF computation in
    opm-common's Connection (Peaceman 1983 with anisotropy correction);
    the ebos research well model does the same (ebos/eclpeacemanwell.hh:185).
    """
    c = act_cell
    if direction == "Z":
        k1, k2 = geo.permx[c], geo.permy[c]
        d1, d2, h = geo.dx[c], geo.dy[c], geo.dz[c] * geo.ntg[c]
    elif direction == "X":
        k1, k2 = geo.permy[c], geo.permz[c]
        d1, d2, h = geo.dy[c], geo.dz[c] * geo.ntg[c], geo.dx[c]
    else:
        k1, k2 = geo.permx[c], geo.permz[c]
        d1, d2, h = geo.dx[c], geo.dz[c] * geo.ntg[c], geo.dy[c]
    r21 = np.sqrt(k2 / k1)
    r12 = np.sqrt(k1 / k2)
    r0 = 0.28 * np.sqrt(r21 * d1 * d1 + r12 * d2 * d2) / (np.sqrt(r21) + np.sqrt(r12))
    keff = np.sqrt(k1 * k2)
    if kh is None:
        kh = keff * h
    rw = diameter / 2.0
    return 2.0 * np.pi * kh / (np.log(r0 / rw) + skin)

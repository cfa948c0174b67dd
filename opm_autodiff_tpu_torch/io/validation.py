"""Deck keyword validation + saturation-table diagnostics.

Rebuild of the reference's KeywordValidation / UnsupportedFlowKeywords /
PartiallySupportedFlowKeywords tables (opm/simulators/flow/
KeywordValidation.hpp:19, UnsupportedFlowKeywords.cpp) and the
RelpermDiagnostics startup checks (opm/core/props/satfunc/
RelpermDiagnostics.cpp, invoked at eclproblem.hh:806). Both produce
human-readable messages collected by the caller (the CLI prints them;
the Python API exposes them on the simulator)."""

from __future__ import annotations

import numpy as np

# Keywords the framework deliberately does not support (error-grade in
# the reference's tables). Anything not recognized at all is reported as
# "ignored" (the tokenizer skips it defensively).
UNSUPPORTED = {
    "API": "API tracking is not implemented",
    "GASFIELD": "field gas options are not implemented",
}

# Supported with caveats (warn-grade).
PARTIAL = {
    "EHYSTR": "Killough scanning covers gas and water/oil relperm; "
              "capillary-pressure hysteresis is not modeled",
    "MISCIBLE": "MISC/PMISC/SSFN/MSFN miscibility with SORWMIS/SGCWMIS "
                "endpoint shifts (relperm effects as lagged multipliers)",
    "WPAVE": "WBP/WBP9 use pore-volume weighting regardless of the "
             "WPAVE weighting options",
    "PVTWSALT": "brine feedback covers water viscosity (not Bw/density)",
    "PVTSOL": "extbo zFraction PVT as factors vs the z=0 branch "
              "(models/extbo.py schema; wells see z through viscosity "
              "factors and stream splits, not through B factors)",
    "ROCKCOMP": "rock compaction uses the ROCK second-order expansion",
    "TUNING": "TSINIT/TSMAXZ/TSMINZ/TSFMAX/TSFMIN are honored; the record-2/3 solver knobs are not",
}


def validate_deck(deck) -> list[str]:
    """Messages for unsupported / partially-supported keywords present."""
    msgs = []
    seen = set()
    for kw in deck:
        if kw.name in seen:
            continue
        seen.add(kw.name)
        if kw.name in UNSUPPORTED:
            msgs.append(f"ERROR  {kw.name}: {UNSUPPORTED[kw.name]} "
                        f"({kw.location})")
        elif kw.name in PARTIAL:
            msgs.append(f"WARN   {kw.name}: {PARTIAL[kw.name]} "
                        f"({kw.location})")
    return msgs


def relperm_diagnostics(props) -> list[str]:
    """Saturation-table sanity checks (RelpermDiagnostics.cpp subset):
    node monotonicity, kr within [0,1], zero kr at the first node, and
    endpoint consistency between SWOF and SGOF."""
    msgs = []

    def check_table(name, t, idx):
        s = t[:, 0]
        if not np.all(np.diff(s) > 0):
            msgs.append(f"ERROR  {name} region {idx + 1}: saturation "
                        "nodes not strictly increasing")
        for col, cn in ((1, "kr"), (2, "kr")):
            v = t[:, col]
            if v.min() < 0 or v.max() > 1.0 + 1e-12:
                msgs.append(f"ERROR  {name} region {idx + 1}: {cn} "
                            "outside [0, 1]")
        if t[0, 1] > 1e-12:
            msgs.append(f"WARN   {name} region {idx + 1}: nonzero kr at "
                        "the first saturation node")
        if not (np.all(np.diff(t[:, 1]) >= 0)):
            msgs.append(f"WARN   {name} region {idx + 1}: kr column 1 "
                        "is not monotone")

    for idx, t in enumerate(props.swof_regions or []):
        check_table("SWOF", np.asarray(t), idx)
    for idx, t in enumerate(props.sgof_regions or []):
        check_table("SGOF", np.asarray(t), idx)

    nswof = len(props.swof_regions or [])
    nsgof = len(props.sgof_regions or [])
    for idx in range(min(nswof, nsgof)):
        swof = np.asarray(props.swof_regions[idx])
        sgof = np.asarray(props.sgof_regions[idx])
        swl = swof[0, 0]
        sg_max = sgof[-1, 0]
        if sg_max > 1.0 - swl + 1e-9:
            msgs.append(f"WARN   region {idx + 1}: SGOF max gas "
                        f"saturation {sg_max:.3f} exceeds 1 - SWL "
                        f"({1.0 - swl:.3f})")
        if abs(swof[0, 2] - sgof[0, 2]) > 1e-6:
            msgs.append(f"WARN   region {idx + 1}: krow(SWL) != krog(0) "
                        "— inconsistent maximum oil relperm")
    return msgs

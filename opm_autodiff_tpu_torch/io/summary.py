"""Summary output: the scientific metric stream of a run.

Round-1 format: in-memory rows + CSV/NPZ writers with values converted
back to deck units (FIELD/METRIC), covering the F*/W* vectors the SPE
decks request. ECL binary SMSPEC/UNSMRY compatibility is a later round
(SURVEY.md §7 stage 10); the *semantic* layer (which vectors, what units)
lives here and the binary encoder will reuse it.
(Reference: EclWriter::evalSummaryState, ebos/eclwriter.hh:143.)
"""

from __future__ import annotations

import numpy as np

from opm_autodiff_tpu_torch import units as U
from opm_autodiff_tpu_torch.io.state import EclState

# unit kind per summary mnemonic prefix (SI -> deck conversion)
_RATE_KIND = {
    "OPR": "liquid_rate", "WPR": "liquid_rate", "GPR": "gas_rate",
    "LPR": "liquid_rate", "OIR": "liquid_rate", "WIR": "liquid_rate",
    "GIR": "gas_rate",
    "OPT": "liquid_volume", "WPT": "liquid_volume", "GPT": "gas_volume",
    "OIT": "liquid_volume", "WIT": "liquid_volume", "GIT": "gas_volume",
    "BHP": "pressure", "THP": "pressure", "PR": "pressure",
    "BP": "pressure", "BP9": "pressure",  # WPAVE block averages
    "GOR": "gas_oil_ratio",
    "AQR": "liquid_rate", "AQT": "liquid_volume",
}


def _to_deck_units(mnemonic: str, value_si: float, u: U.UnitSystem) -> float:
    base = mnemonic.split(":")[0]
    kind = _RATE_KIND.get(base[1:], None)
    if kind is None:
        return value_si
    if kind.endswith("_rate"):
        return value_si / getattr(u, kind)
    return value_si / getattr(u, kind)


class SummaryWriter:
    def __init__(self, state: EclState):
        self.unit = state.runspec.unit_system
        self.rows: list[dict] = []

    def end_report_step(self, time_days: float, values_si: dict):
        row = {"TIME": time_days}
        for k, v in values_si.items():
            row[k] = _to_deck_units(k, v, self.unit)
        self.rows.append(row)

    # ------------------------------------------------------------------
    def columns(self) -> list[str]:
        cols: list[str] = []
        for r in self.rows:
            for k in r:
                if k not in cols:
                    cols.append(k)
        return cols

    def to_csv(self, path: str):
        cols = self.columns()
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for r in self.rows:
                f.write(",".join(f"{r.get(c, float('nan')):.8g}"
                                 for c in cols) + "\n")

    def to_npz(self, path: str):
        cols = self.columns()
        arrays = {c: np.asarray([r.get(c, np.nan) for r in self.rows])
                  for c in cols}
        np.savez(path, **arrays)

    def series(self, mnemonic: str) -> np.ndarray:
        return np.asarray([r.get(mnemonic, np.nan) for r in self.rows])

"""ECLIPSE-format deck tokenizer and keyword reader.

A minimal, dependency-free replacement for the slice of opm-common's
``Parser -> Deck`` pipeline that the reference traverses
(reference: opm/simulators/utils/readDeck.cpp:189). Covers the SPE1..Norne
keyword set per SURVEY.md §7 stage 1. Produces a flat list of
``DeckKeyword`` objects; semantic interpretation (units, defaults, array
expansion) happens in :mod:`opm_autodiff_tpu_torch.io.state`.

Grammar handled here:
  * ``--`` comments to end of line
  * records terminated by ``/`` (text after the slash on a line is comment)
  * repeat counts ``N*`` (N defaulted items) and ``N*val`` (N copies)
  * quoted strings ``'PROD'``
  * ``INCLUDE`` files (relative to the including file)
  * keyword classification: flag / single-record / multi-record /
    grid-array / table (multi-record where an empty record ends a sub-table)
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterator

# Sentinel for a defaulted item ("1*" or trailing omission).
DEFAULT = object()


@dataclasses.dataclass
class DeckKeyword:
    name: str
    # For RECORDS-style keywords: list of records, each a list of items
    # (str | float | int | DEFAULT). For DATA-style: one flat list.
    records: list
    location: str = ""
    # ACTIONX payload: the keywords between the condition block and
    # ENDACTIO, to be applied when the action triggers
    sub: list = dataclasses.field(default_factory=list)

    def flat(self) -> list:
        out = []
        for r in self.records:
            out.extend(r)
        return out


@dataclasses.dataclass
class Deck:
    keywords: list[DeckKeyword]

    def __iter__(self) -> Iterator[DeckKeyword]:
        return iter(self.keywords)

    def __contains__(self, name: str) -> bool:
        return any(kw.name == name for kw in self.keywords)

    def get(self, name: str) -> list[DeckKeyword]:
        return [kw for kw in self.keywords if kw.name == name]

    def get1(self, name: str) -> DeckKeyword | None:
        for kw in self.keywords:
            if kw.name == name:
                return kw
        return None


# ----------------------------------------------------------------------------
# Keyword registry: how to consume each keyword's body.
# ----------------------------------------------------------------------------
# FLAG: no body. SINGLE: one '/'-terminated record. RECORDS: records until an
# empty record ('/' alone). DATA: numeric items until one '/'. TABLES: like
# RECORDS but tables of tables (e.g. PVTO: each record is one Rs branch ended
# by '/', table set ends with an empty record).

FLAG, SINGLE, RECORDS, DATA, TABLES, SPECIAL = range(6)

SECTION_KEYWORDS = {
    "RUNSPEC", "GRID", "EDIT", "PROPS", "REGIONS",
    "SOLUTION", "SUMMARY", "SCHEDULE",
}

FLAG_KEYWORDS = {
    "OIL", "WATER", "GAS", "DISGAS", "VAPOIL", "FIELD", "METRIC", "LAB",
    "POLYMER", "BRINE", "FOAM", "SOLVENT", "TEMP", "THERMAL",
    "UNIFIN", "UNIFOUT", "UNIFSAVE", "MULTIN", "MULTOUT", "NOSIM", "IMPES",
    "NONNC", "NOGRAV", "ECHO", "NOECHO", "FMTIN", "FMTOUT", "INIT",
    "NOINSPEC", "NORSSPEC", "SKIPREST", "END", "ENDBOX", "NEWTRAN",
    "OLDTRAN", "GRIDUNIT", "MONITOR", "RSSPEC", "MSGFILE", "NOMONITO",
    "NOHYST", "CIRCLE", "NODPPM", "AUTOCOAR", "ENDACTIO",
}

SINGLE_KEYWORDS = {
    "DIMENS", "START", "EQLDIMS", "TABDIMS", "WELLDIMS", "VFPPDIMS",
    "VFPIDIMS", "AQUDIMS", "FAULTDIM", "PIMTDIMS", "NSTACK", "OPTIONS",
    "SATOPTS", "EHYSTR", "ROCKCOMP", "ROCKOPTS", "MISCIBLE", "NUPCOL",
    "TRACERS", "SMRYDIMS", "REGDIMS", "GRIDOPTS", "RPTONLY", "BIGMODEL",
    "NETWORK", "LIFTOPT", "WSEGDIMS", "UDQDIMS", "UDADIMS",
    "ACTDIMS", "RESTART", "RPTRST", "RPTSOL", "RPTSCHED", "RPTGRID",
    "RPTPROPS", "OUTSOL", "TITLE", "SCALECRS", "ENDSCALE",
}

RECORDS_KEYWORDS = {
    "WELSPECS", "COMPDAT", "WCONPROD", "WCONINJE", "WCONHIST", "WCONINJH",
    "WELTARG", "WELOPEN", "COMPLUMP", "WPIMULT", "WEFAC", "WTEST", "WECON", "WELSEGS",
    "COMPSEGS", "WSEGVALV", "GRUPTREE", "GCONPROD", "GCONINJE", "GEFAC",
    "GUIDERAT", "WGRUPCON",
    "GRUPNET", "NODEPROP", "BRANPROP", "NETBALAN", "EQUALS", "COPY", "ADD",
    "MULTIPLY",
    "MULTIREG", "BOX", "FAULTS", "MULTFLT", "PINCH", "NNC", "EDITNNC",
    "AQUCT", "AQUFETP", "AQUANCON", "AQUFLUX", "AQUNUM", "AQUCON",
    "ROCK", "ROCKTAB",
    "TRACER", "WTRACER", "VFPPROD", "VFPINJ",
    "DENSITY", "GRAVITY", "PVTW", "PVCDO", "EQUIL", "RPTRST", "TUNING",
    "WLIFTOPT", "GLIFTOPT", "MESSAGES", "DATES", "THPRES", "WRFTPLT",
    "COMPORD", "WSEGITER", "PIMULTAB", "WPAVE", "WELPI", "MULTPV",
    "PLYROCK", "PLYMAX", "WPOLYMER", "WSALT", "WFOAM",
    "FOAMFSC", "PVTWSALT", "SALTVD", "TEMPVD", "RTEMPVD", "FOAMROCK", "WSOLVENT", "TLMIXPAR",
    "UDQ", "ACTIONX", "WTEMP", "WINJTEMP", "VISCREF", "DRSDT", "DRVDT",
    # depth-interpolated end-point scaling tables (one record per
    # endpoint region, RSVD-style): reference satfuncEPS_B.DATA
    "ENPTVD", "ENKRVD",
}

DATA_KEYWORDS = {
    "DX", "DY", "DZ", "DXV", "DYV", "DZV", "TOPS", "DEPTHZ", "PORO",
    "PERMX", "PERMY", "PERMZ", "NTG", "ACTNUM", "MULTX", "MULTY", "MULTZ",
    "MULTX-", "MULTY-", "MULTZ-", "COORD", "ZCORN", "SATNUM", "PVTNUM",
    "EQLNUM", "FIPNUM", "IMBNUM", "ENDNUM", "MINPV", "PRESSURE", "SWAT",
    "SGAS", "RS", "RV", "RSVD", "RVVD", "PBVD", "PDVD", "SWL", "SWU",
    "SWCR", "SGL", "SGU", "SGCR", "SOWCR", "SOGCR", "KRW", "KRO", "KRG",
    "KRWR", "KRORW", "KRORG", "KRGR", "PCW", "PCG", "TRANX", "TRANY",
    "TRANZ", "DIFFX", "DIFFY", "DIFFZ", "THCONR", "DISPERC", "MULTNUM",
    "OPERNUM", "FLUXNUM", "ROCKNUM", "MISCNUM", "TEMPI", "RSW", "SWATINIT",
}

TABLES_KEYWORDS = {
    # one sub-table per region (TABDIMS NTSFUN/NTPVT); PVTO/PVTG have nested
    # branch records.
    "SWOF", "SGOF", "SLGOF", "SWFN", "SGFN", "SGWFN", "SOF2", "SOF3",
    "PVDG", "PVDO",
    "PVTO", "PVTG", "PVTSOL", "RSVD", "RVVD", "PBVD", "PDVD", "PVZG",
    "ROCKTAB",
    "TSTEP", "PLYVISC", "PLYADS", "FOAMMOB", "PVDS", "SSFN", "MSFN",
    "MISC", "PMISC", "SORWMIS", "SGCWMIS",
    "SPECROCK", "SPECHEAT", "WATVISCT", "OILVISCT", "GASVISCT",
}

# TSTEP is really DATA-like (one record of numbers) but may appear many times.
# RSVD/PBVD etc are per-EQLNUM-region tables (RECORDS style, one record per
# region). Resolve overlaps: explicit mode map wins.
MODE_OVERRIDE = {
    "TSTEP": DATA,
    "RSVD": RECORDS,
    "RVVD": RECORDS,
    "PBVD": RECORDS,
    "PDVD": RECORDS,
    "ROCKTAB": TABLES,
    "SUMMARY": SPECIAL,
    "INCLUDE": SPECIAL,
    "TITLE": SPECIAL,
}

# Summary-section vector keywords: bare flag (field/region) or one record of
# well/group names. We accept any keyword inside SUMMARY section generically.

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")
_INT_RE = re.compile(r"^[+-]?\d+$")
_REPEAT_RE = re.compile(r"^(\d+)\*(.*)$")


def _convert(tok: str):
    if tok.startswith("'") or tok.startswith('"'):
        return tok.strip("'\"")
    if _INT_RE.match(tok):
        return int(tok)
    if _NUM_RE.match(tok):
        return float(tok.replace("d", "e").replace("D", "E"))
    return tok


def _expand_token(tok: str) -> list:
    """Expand repeats; return list of parsed items."""
    m = _REPEAT_RE.match(tok)
    if m:
        n = int(m.group(1))
        rest = m.group(2)
        if rest == "":
            return [DEFAULT] * n
        return [_convert(rest)] * n
    if tok == "*":
        return [DEFAULT]
    return [_convert(tok)]


_EXPR_OPS = set("()+-*/^")
_NUM_EXP_TAIL = re.compile(r"^[0-9][0-9.]*[EeDd]$")


def _tokenize_expr(text: str) -> list:
    """Expression tokenizer for UDQ DEFINE bodies (and ACTIONX
    conditions): operators are their own tokens even without
    whitespace (``FOPR+FWPR``, ``MAX(WOPR)``), '/' is division (the
    record terminator was stripped by the caller), and scientific
    literals like ``1.5E+5`` survive the +/- split."""
    out: list = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
        elif c in "'\"":
            j = text.find(c, i + 1)
            j = n - 1 if j < 0 else j
            out.append(text[i + 1:j + 1].rstrip(c))
            i = j + 1
        elif c in _EXPR_OPS:
            # exponent continuation: "1.5E" "+" "5" -> "1.5E+5"
            if (c in "+-" and out and isinstance(out[-1], str)
                    and _NUM_EXP_TAIL.match(out[-1])
                    and i + 1 < n and text[i + 1].isdigit()):
                j = i + 1
                while j < n and (text[j].isdigit() or text[j] == "."):
                    j += 1
                out[-1] = _convert(out[-1] + text[i:j])
                i = j
                continue
            out.append(c)
            i += 1
        elif c in "<>=!":
            two = text[i:i + 2]
            if two in (">=", "<=", "==", "!=", "<>"):
                out.append(two)
                i += 2
            else:
                out.append(c)
                i += 1
        else:
            j = i
            while (j < n and not text[j].isspace()
                   and text[j] not in _EXPR_OPS
                   and text[j] not in "<>=!'\""):
                j += 1
            out.append(_convert(text[i:j]))
            i = j
    return out


def _tokenize_line(line: str) -> list[str]:
    # strip comments
    idx = line.find("--")
    if idx >= 0:
        line = line[:idx]
    out = []
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c.isspace():
            i += 1
            continue
        if c in "'\"":
            j = line.find(c, i + 1)
            if j < 0:
                j = n - 1
            out.append(line[i : j + 1])
            i = j + 1
        elif c == "/":
            out.append("/")
            # everything after a slash on the same line is a comment
            break
        else:
            j = i
            while j < n and not line[j].isspace() and line[j] not in "'\"/":
                j += 1
            out.append(line[i:j])
            i = j
    return out


class _TokenStream:
    def __init__(self, lines: list[tuple[str, str]]):
        # lines: list of (line_text, location)
        self._lines = lines
        self._li = 0
        self._buf: list[str] = []
        self.location = ""

    def peek_line_first(self) -> str | None:
        """First token of the next non-empty line without consuming.

        Only used for keyword-boundary detection, so a cheap whitespace
        split suffices — tokenizing whole multi-MB array lines here was
        a parse hot spot."""
        li = self._li
        if self._buf:
            return self._buf[0]
        while li < len(self._lines):
            text = self._lines[li][0]
            idx = text.find("--")
            if idx >= 0:
                text = text[:idx]
            parts = text.split(None, 1)
            if parts:
                return parts[0]
            li += 1
        return None

    def next_token(self) -> str | None:
        while not self._buf:
            if self._li >= len(self._lines):
                return None
            text, loc = self._lines[self._li]
            self._li += 1
            self._buf = _tokenize_line(text)
            self.location = loc
        return self._buf.pop(0)

    def read_record(self) -> list | None:
        """Read items until '/'. Returns None at EOF with nothing read."""
        items: list = []
        saw_any = False
        while True:
            tok = self.next_token()
            if tok is None:
                return items if saw_any else None
            saw_any = True
            if tok == "/":
                return items
            items.extend(_expand_token(tok))

    def read_expr_records(self, known: set[str]) -> list:
        """UDQ-style expression records (reference: opm-common's UDQ
        parser). Unlike normal records, a '/' mid-line is DIVISION;
        only the '/' ending a line terminates the record. A bare '/'
        line (or a line starting a known keyword) closes the keyword."""
        recs: list = []
        cur: list = []
        self._buf = []  # records start on the following line
        while self._li < len(self._lines):
            text, loc = self._lines[self._li]
            idx = text.find("--")
            if idx >= 0:
                text = text[:idx]
            stripped = text.strip()
            if not stripped:
                self._li += 1
                continue
            first = stripped.split(None, 1)[0].upper().strip("'\"")
            if not cur and first in known:
                break  # unterminated keyword: next keyword starts
            self._li += 1
            self.location = loc
            ends = stripped.endswith("/")
            if ends:
                stripped = stripped[:-1].rstrip()
            cur.extend(_tokenize_expr(stripped))
            if ends:
                if not cur:
                    break  # bare '/' closes the keyword
                recs.append(cur)
                cur = []
        if cur:
            recs.append(cur)
        return recs

    def read_data_fast(self):
        """Native bulk-number fast path for DATA keyword bodies
        (native/decklex.cpp): one C pass over the raw lines up to the
        terminating '/'. Returns a float64 numpy array, or None when the
        body needs the general tokenizer (defaults, strings, or the
        native library is unavailable)."""
        if self._buf:
            return None  # data shares the keyword's line: rare, fall back
        from opm_autodiff_tpu_torch.io import decklex

        if not decklex.available():
            return None
        # find the line holding the terminating '/' (comments stripped)
        li = self._li
        end = None
        while li < len(self._lines):
            text = self._lines[li][0]
            idx = text.find("--")
            body = text[:idx] if idx >= 0 else text
            if "/" in body:
                end = li
                break
            li += 1
        if end is None:
            return None
        buf = "\n".join(self._lines[i][0]
                        for i in range(self._li, end + 1))
        vals = decklex.parse_numbers(buf)
        if vals is None:
            return None
        self._li = end + 1
        if end < len(self._lines):
            self.location = self._lines[end][1]
        return vals

    def skip_to_next_keyword(self, known: set[str]):
        """Consume lines until the first token of a line is a known keyword."""
        while True:
            first = self.peek_line_first()
            if first is None:
                return
            if first.upper() in known and not self._buf:
                return
            # consume one line
            if self._buf:
                self._buf = []
            else:
                self._li += 1


def _is_keyword_token(tok: str) -> bool:
    t = tok.upper()
    return bool(re.match(r"^[A-Z][A-Z0-9_+-]{0,7}$", t))


def _load_lines(path: str) -> list[tuple[str, str]]:
    with open(path, "r", errors="replace") as f:
        return [(ln.rstrip("\n"), f"{os.path.basename(path)}:{i+1}")
                for i, ln in enumerate(f)]


def read_deck(path: str) -> Deck:
    lines = _expand_includes(path)
    stream = _TokenStream(lines)
    keywords: list[DeckKeyword] = []
    section = None
    all_known = (SECTION_KEYWORDS | FLAG_KEYWORDS | SINGLE_KEYWORDS
                 | RECORDS_KEYWORDS | DATA_KEYWORDS | TABLES_KEYWORDS
                 | set(MODE_OVERRIDE))

    pending_action = None  # ACTIONX being filled until ENDACTIO

    def emit(kw):
        if pending_action is not None and kw.name != "ACTIONX":
            pending_action.sub.append(kw)
        else:
            keywords.append(kw)

    while True:
        tok = stream.next_token()
        if tok is None:
            break
        name = tok.upper().strip("'\"")
        if not _is_keyword_token(name):
            # stray token (e.g. junk after a record) — skip
            continue
        loc = stream.location

        if name == "ENDACTIO":
            pending_action = None
            continue
        if name in SECTION_KEYWORDS:
            section = name
            keywords.append(DeckKeyword(name, [], loc))
            continue
        if name == "END":
            break

        if name == "UDQ":
            emit(DeckKeyword(name, stream.read_expr_records(all_known),
                             loc))
            continue

        mode = MODE_OVERRIDE.get(name)
        if mode is None:
            if name in FLAG_KEYWORDS:
                mode = FLAG
            elif name in SINGLE_KEYWORDS:
                mode = SINGLE
            elif name in RECORDS_KEYWORDS:
                mode = RECORDS
            elif name in DATA_KEYWORDS:
                mode = DATA
            elif name in TABLES_KEYWORDS:
                mode = TABLES
            elif name.startswith("TBLKF"):
                mode = DATA  # per-tracer initial concentration arrays
            elif section == "SUMMARY":
                mode = SPECIAL  # summary vector keyword
            else:
                # Unknown keyword: consume records defensively until a line
                # starts with a known keyword.
                stream.skip_to_next_keyword(all_known)
                continue

        if mode == FLAG:
            emit(DeckKeyword(name, [], loc))
        elif mode == SINGLE:
            rec = stream.read_record() or []
            emit(DeckKeyword(name, [rec], loc))
        elif mode == DATA:
            rec = stream.read_data_fast()
            if rec is None:
                rec = stream.read_record() or []
            emit(DeckKeyword(name, [rec], loc))
        elif mode in (RECORDS, TABLES):
            recs = []
            # box-operation records legitimately START with array-keyword
            # names (COPY: "PERMX PERMY /") — only a section header may
            # break them; they always carry their terminating "/"
            ops = name in ("COPY", "EQUALS", "ADD", "MULTIPLY", "MULTIREG")
            breakers = SECTION_KEYWORDS if ops else all_known
            while True:
                # stop when the next line begins with a known keyword and we
                # are between records (handles keywords without terminating
                # empty record, which is legal in ECL decks)
                first = stream.peek_line_first()
                if first is not None and first.upper() in breakers:
                    break
                rec = stream.read_record()
                if rec is None:
                    break
                if not rec:
                    if mode == TABLES:
                        # empty record separates per-region sub-tables
                        # (e.g. PVTO: NTPVT tables each closed by '/');
                        # keep the marker — parsers split on it
                        recs.append([])
                        continue
                    break  # empty record '/' terminates the keyword
                recs.append(rec)
            kw_obj = DeckKeyword(name, recs, loc)
            emit(kw_obj)
            if name == "ACTIONX":
                pending_action = kw_obj
        elif mode == SPECIAL:
            if name == "TITLE":
                # title is free text on the following line
                stream.next_token()
                stream._buf = []
                keywords.append(DeckKeyword(name, [], loc))
            elif name == "INCLUDE":
                # handled in _expand_includes; should not reach here
                stream.read_record()
            else:
                # SUMMARY vector: may be a flag (FOPR) or have one record of
                # well/group names (WOPR 'PROD' /). Peek: if next line starts
                # with a known keyword or another plausible summary mnemonic,
                # treat as flag.
                first = stream.peek_line_first()
                if first is not None and (first.upper() in all_known
                                          or _looks_like_summary_kw(first)):
                    keywords.append(DeckKeyword(name, [], loc))
                else:
                    rec = stream.read_record() or []
                    keywords.append(DeckKeyword(name, [rec], loc))
    return Deck(keywords)


def _looks_like_summary_kw(tok: str) -> bool:
    t = tok.upper()
    return bool(re.match(r"^[FWGRBC][A-Z]{2,7}$", t)) and not t.startswith("'")


def _expand_includes(path: str) -> list[tuple[str, str]]:
    base = os.path.dirname(os.path.abspath(path))
    out: list[tuple[str, str]] = []
    for text, loc in _load_lines(path):
        toks = _tokenize_line(text)
        if toks and toks[0].upper().strip("'\"") == "INCLUDE":
            # filename may be on the same or next line; find it in this line
            # first. We only support same-line or immediate-next-line form.
            rest = [t for t in toks[1:] if t != "/"]
            if rest:
                fname = rest[0].strip("'\"")
                out.extend(_expand_includes(os.path.join(base, fname)))
                continue
            else:
                # next non-empty line holds the filename
                out.append(("__INCLUDE_PENDING__", loc))
                continue
        if out and out[-1][0] == "__INCLUDE_PENDING__":
            fn = [t for t in toks if t != "/"]
            out.pop()
            if fn:
                out.extend(_expand_includes(os.path.join(base, fn[0].strip("'\""))))
            continue
        out.append((text, loc))
    return out

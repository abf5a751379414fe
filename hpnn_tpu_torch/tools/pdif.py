"""``pdif`` — RRUFF XRD database → NN sample files.

Reimplements the reference converter pipeline byte-for-byte on output
(ref: libhpnn tutorials/ann/prepare_dif.c, file_dif.c):

* parse ``<rruff>/dif/<file>`` — temperature (``T =``, Celsius unless a
  ``K`` unit follows), cell parameters (mandatory), space-group symbol
  → IT number via the sgdata table, wavelength, 2-THETA peak list
  (mandatory) (ref: file_dif.c read_dif);
* parse the matching ``<rruff>/raw/<file>`` raw spectrum
  (ref: file_dif.c read_raw);
* histogram-integrate the raw intensities into ``n_in`` bins over
  2θ∈[5°,90°], normalize to the max bin, prepend T/273.15 as an extra
  input, and one-hot the space group over ``n_out`` outputs in {−1,1}
  (ref: file_dif.c dif_2_sample);
* skip quirks preserved: first-line ``R060187``/``5.000`` bailouts,
  Mo-radiation files (λ=0.710730), and the partial ``[input]`` header
  left behind when a spectrum integrates to zero.
"""

from __future__ import annotations

import os
import re
import sys

from hpnn_tpu_torch.tools.sgdata import SG_NUMBER

MIN_THETA = 5.0
MAX_THETA = 90.0

_FLOAT = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")

# strtod at the START of the remainder (the reference's GET_DOUBLE
# chain walks the line; a stray word between numbers fails the row,
# unlike a find-anywhere regex).  Covers strtod's full grammar: the
# decimal forms plus the case-insensitive INF/INFINITY and
# NAN/NAN(n-char-seq) forms — an ATOM row carrying "nan" occupancy is
# a valid strtod parse (the reference would accept it), so it must
# consume here rather than fail the whole file.
_LEAD_FLOAT = re.compile(
    r"[ \t\n\r\f\v]*([-+]?(?:"
    r"\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
    r"|[-+]?(?:[iI][nN][fF](?:[iI][nN][iI][tT][yY])?"
    r"|[nN][aA][nN](?:\([0-9A-Za-z_]*\))?))")

# The 119-symbol element table of the reference's atom.def
# (crystallographic constants; ref: tutorials/ann/atom.def:3).  Index
# IS the atomic number Z ("X"=0 unknown).
ATOM_SYMB = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na",
    "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V",
    "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se",
    "Br", "Kr", "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh",
    "Pd", "Ag", "Cd", "In", "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba",
    "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho",
    "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt",
    "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac",
    "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds", "Rg",
    "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]


def _match_atom(s: str) -> int | None:
    """The reference's ATM_IS_EQ walk (file_dif.c:171-206): descending
    index over atom_symb; a 1-char symbol needs a following blank, a
    2-char symbol needs its second char.  Returns Z or None.

    Faithfulness notes: the C starts at atom_symb[MAX_ATOMS] — one
    PAST the table (out-of-bounds read, practically never a match) —
    we start at the last real entry; the "I before In"/"S before Si"/
    "B before Be" remaps are unreachable given ATM_IS_EQ (a 1-char
    symbol can only match when followed by a blank), so they are not
    reproduced."""
    c0 = s[0] if s else ""
    c1 = s[1] if len(s) > 1 else "\n"
    for idx in range(len(ATOM_SYMB) - 1, 0, -1):
        sym = ATOM_SYMB[idx]
        if c0 != sym[0]:
            continue
        if len(sym) == 1:
            if c1.isspace():
                return idx
        elif c1 == sym[1]:
            return idx
    return None


def _parse_atom_row(s: str) -> str:
    """One ATOM row → "atom" | "skip" | "fail" (file_dif.c:166-268).

    An element hit consumes exactly 2 chars, then must GET_DOUBLE five
    fields (x y z occ B); any parse failure FAILs the whole file (the
    reference's ASSERT_GOTO → read_dif returns NULL and prepare_dif
    skips the file).  A row matching NO element is silently skipped:
    the OH/Wa/Ow/Oh→O and unknown-X arms sit behind ``if(idx<0)`` with
    ``UINT idx`` (file_dif.c:46,214) — dead code, mirrored as written,
    not as commented."""
    if _match_atom(s) is None:
        return "skip"
    rest = s[2:]
    for _ in range(5):
        m = _LEAD_FLOAT.match(rest)
        if m is None:
            return "fail"
        rest = rest[m.end():]
        # GET_DOUBLE chains advance one char past the number, then
        # SKIP_BLANK — subsumed by the leading-blank strtod match
        rest = rest[1:]
    return "atom"


class Dif:
    def __init__(self):
        self.name = "???"
        self.temp = 273.15 + 25.0  # room temperature
        self.cell = None
        self.space = 0  # 0 -> unknown
        self.natoms = 0
        self.lambda_ = 1.541838  # all dif files have this wavelength
        self.peaks: list[tuple[float, float]] = []
        self.raw_t: list[float] = []
        self.raw_i: list[float] = []


def _floats_at(s: str, count: int) -> list[float] | None:
    vals = _FLOAT.findall(s)
    if len(vals) < count:
        return None
    return [float(v) for v in vals[:count]]


def read_dif(path: str) -> Dif | None:
    try:
        with open(path, "r", errors="replace") as fp:
            lines = fp.readlines()
    except OSError:
        sys.stderr.write(f"Error opening file: {path}\n")
        return None
    if not lines:
        return None
    first = lines[0]
    # 4 files lack full set information; bail like the reference
    if "R060187" in first or "5.000" in first:
        return None
    dif = Dif()
    tok = first.split()
    if tok:
        dif.name = tok[0]
    i = 1
    n = len(lines)
    while i < n:
        line = lines[i]
        if "Sample" in line:
            m = re.search(r"T =\s*(" + _FLOAT.pattern + r")", line)
            if m:
                dif.temp = float(m.group(1))
                # unit char one past the number's end; Kelvin only if 'K'
                j = m.end(1) + 1
                if j >= len(line) or line[j] != "K":
                    dif.temp += 273.15
        if "CELL PARAMETERS:" in line:
            rest = line.split("CELL PARAMETERS:", 1)[1]
            vals = _floats_at(rest, 6)
            if vals is None:
                return None  # mandatory
            dif.cell = tuple(vals)
        p = line.find("SPACE GROUP")
        if p >= 0:
            q = p + 11
            # one file has "SPACE GROUP #:" instead of "SPACE GROUP:"
            if q < len(line) and line[q] != ":":
                q += 1
            q += 2
            sym = ""
            while q < len(line) and line[q].isprintable() and not line[q].isspace():
                sym += line[q]
                q += 1
            dif.space = SG_NUMBER.get(sym, 0)
            if dif.space == 0:
                sys.stdout.write(f"#DBG: NO_space group = {sym}\n")
        if "ATOM" in line:
            # atom rows follow while the line's first graphic char is a
            # non-digit; each row goes through the element-symbol walk
            # (file_dif.c:166-268 — mechanism-for-mechanism, see
            # _parse_atom_row): a malformed matched row fails the WHOLE
            # file, an unmatched symbol is silently skipped
            i += 1
            while i < n:
                s = lines[i].lstrip(" \t")
                c = s[:1]
                if not c or c.isdigit() or c.isspace() or not c.isprintable():
                    break
                res = _parse_atom_row(s)
                if res == "fail":
                    return None
                if res == "atom":
                    dif.natoms += 1
                i += 1
            continue
        if "WAVELENGTH" in line:
            m = _FLOAT.search(line[line.find("WAVELENGTH") :])
            if m:
                dif.lambda_ = float(m.group(0))
        if "2-THETA" in line:
            i += 1
            while i < n:
                s = lines[i].lstrip(" \t")
                if not s or not s[0].isdigit():
                    break
                vals = _floats_at(s, 2)
                if vals is None:
                    break
                dif.peaks.append((vals[0], vals[1]))
                i += 1
            continue
        i += 1
    if not dif.peaks:
        return None
    return dif


def read_raw(path: str, dif: Dif) -> bool:
    try:
        with open(path, "r", errors="replace") as fp:
            lines = fp.readlines()
    except OSError:
        sys.stderr.write(f"Error opening file: {path}\n")
        return False
    i = 0
    n = len(lines)
    # skip header lines (until a line STARTS with a digit, no blanks)
    while i < n and not lines[i][:1].isdigit():
        i += 1
    if i >= n:
        return False
    for line in lines[i:]:
        vals = _floats_at(line, 2)
        if vals is None:
            continue  # permissive, like the reference
        dif.raw_t.append(vals[0])
        dif.raw_i.append(vals[1])
    return True


def dif_2_sample(dif: Dif, fp, n_inputs: int, n_outputs: int) -> bool:
    """Histogram-integrate + normalize + one-hot (file_dif.c:425-478).

    ``n_inputs`` INCLUDES the temperature input (bins = n_inputs−1).
    On a zero spectrum the ``[input]`` header has already been written
    — the reference leaves that partial file behind, and so do we.
    """
    if n_inputs == 0 or n_outputs == 0:
        return False
    fp.write("[input] %i\n" % n_inputs)
    n_bins = n_inputs - 1
    interval = (MAX_THETA - MIN_THETA) / n_bins
    samples = [0.0] * n_bins
    j = 0
    n_raw = len(dif.raw_t)
    while j < n_raw and dif.raw_t[j] < MIN_THETA:
        j += 1
    hi = MIN_THETA + interval
    max_i = 0.0
    for b in range(n_bins):
        acc = 0.0
        while j < n_raw and dif.raw_t[j] < hi:
            acc += dif.raw_i[j]
            j += 1
        hi += interval
        samples[b] = acc
        if acc > max_i:
            max_i = acc
    if max_i == 0.0:
        return False
    fp.write("%7.5f" % (dif.temp / 273.15))
    for b in range(n_bins):
        fp.write(" %7.5f" % (samples[b] / max_i))
    fp.write("\n")
    fp.write("[output] %i\n" % n_outputs)
    fp.write("1.0" if dif.space == 1 else "-1.0")
    for idx in range(1, n_outputs):
        fp.write(" 1.0" if idx == dif.space - 1 else " -1.0")
    fp.write("\n")
    return True


def dump_help() -> None:
    w = sys.stdout.write
    w("********************************************\n")
    w("usage: pdif rruff_directory -i n_in -o n_out\n")
    w("********************************************\n")
    w("rruff_directory: where dif and raw directory\n")
    w("are located.\n")
    w("-i n_in: number of input samples -MANDATORY!\n")
    w("-o n_out: number of outputs -ALSO MANDATORY!\n")
    w("-s dir: samples output directory (./samples)\n")
    w("********************************************\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--json" in argv:
        # machine-readable mode (for CI / ledger_diff-style consumers):
        # the whole text protocol still runs — captured, not printed —
        # and one JSON report document goes to the real stdout
        argv.remove("--json")
        return _main_json(argv)
    return _run(argv, None)


def _main_json(argv: list[str]) -> int:
    import contextlib
    import io
    import json

    report = {"ok": True, "params": {}, "written": [], "skipped": []}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = _run(argv, report)
    report["exit_code"] = code
    report["ok"] = code == 0
    report["stdout_lines"] = buf.getvalue().splitlines()
    sys.stdout.write(json.dumps(report) + "\n")
    return code


def _skip(report, name: str, reason: str) -> None:
    if report is not None:
        report["skipped"].append({"file": name, "reason": reason})


def _run(argv: list[str], report) -> int:
    if len(argv) < 3:
        dump_help()
        return 1
    n_inputs = n_outputs = 0
    rruff_dir = None
    sample_dir = None
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("-") and len(arg) > 1:
            c = arg[1]
            val = arg[2:] if len(arg) > 2 else None
            if c == "h":
                dump_help()
                return 0
            if c in "ios":
                if val is None:
                    i += 1
                    if i >= len(argv):
                        sys.stderr.write(f"syntax error: bad -{c} parameter!\n")
                        dump_help()
                        return 1
                    val = argv[i]
                if c == "s":
                    sample_dir = val
                else:
                    if not val[:1].isdigit() or int(re.match(r"\d+", val).group(0)) == 0:
                        sys.stderr.write(f"syntax error: bad -{c} parameter!\n")
                        dump_help()
                        return 1
                    num = int(re.match(r"\d+", val).group(0))
                    if c == "i":
                        n_inputs = num + 1  # +1 for temperature
                    else:
                        n_outputs = num
            else:
                sys.stderr.write("syntax error: unrecognized option!\n")
                dump_help()
                return 1
        else:
            if rruff_dir is not None:
                sys.stderr.write("syntax error: too many parameters!\n")
                dump_help()
                return 1
            rruff_dir = arg
        i += 1
    if sample_dir is None:
        sample_dir = "./samples"
    if report is not None:
        report["params"] = {"rruff_dir": rruff_dir, "n_inputs": n_inputs,
                            "n_outputs": n_outputs,
                            "sample_dir": sample_dir}
    sys.stdout.write(
        ">> received: %s -i %i -o %i -s %s\n"
        % (rruff_dir, n_inputs, n_outputs, sample_dir)
    )
    if not os.path.isdir(sample_dir):
        sys.stderr.write(f"ERROR: can't open directory: {sample_dir}\n")
        return 1
    dif_dir = os.path.join(rruff_dir, "dif")
    if not os.path.isdir(dif_dir):
        sys.stderr.write(f"ERROR: can't open directory: {dif_dir}/\n")
        return 1
    with os.scandir(dif_dir) as it:
        entries = [e.name for e in it if not e.name.startswith(".") and e.is_file()]
    for name in entries:
        sys.stdout.write(f"Processing file: {name}\n")
        dif = read_dif(os.path.join(dif_dir, name))
        if dif is None:
            sys.stderr.write(f"ERROR:  reading {name} file! SKIP\n")
            _skip(report, name, "read_dif")
            continue
        if dif.lambda_ == 0.710730:
            sys.stderr.write(
                f"ERROR:  file {name} has wavelength of 0.710730! SKIP\n"
            )
            _skip(report, name, "mo_radiation")
            continue
        raw_path = os.path.join(rruff_dir, "raw", name)
        if not read_raw(raw_path, dif):
            sys.stderr.write(f"ERROR: reading {raw_path} file! SKIP\n")
            _skip(report, name, "raw")
            continue
        out_path = os.path.join(sample_dir, name)
        try:
            with open(out_path, "w") as fp:
                if not dif_2_sample(dif, fp, n_inputs, n_outputs):
                    sys.stderr.write(f"ERROR: writting {out_path} sample file!\n")
                    # the partial [input] header stays behind, like the
                    # reference — reported as skipped, not written
                    _skip(report, name, "zero_spectrum")
                elif report is not None:
                    report["written"].append(name)
        except OSError:
            sys.stderr.write(f"ERROR: opening {out_path} sample file for WRITE!\n")
            _skip(report, name, "open")
            continue
    return 0


if __name__ == "__main__":
    sys.exit(main())

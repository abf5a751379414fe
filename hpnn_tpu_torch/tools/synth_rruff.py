"""``synth_rruff`` — deterministic synthetic RRUFF-XRD dif/raw dataset.

The reference's second acceptance protocol is the RRUFF space-group
task: download XRD ``dif`` + ``raw`` archives from rruff.info, convert
with ``pdif -i 850 -o 230``, train an 851-230-230 ANN with BPM
(ref: libhpnn tutorials/ann/tutorial.bash:9,100-158).  Those
archives need a download, so this tool generates a stand-in
dataset IN THE SAME CONTAINER FORMAT — paired ``<dir>/dif/Rxxxxxx``
and ``<dir>/raw/Rxxxxxx`` text files with the header lines, cell
parameters, Hermann-Mauguin space-group symbols, 2-THETA peak tables
and raw spectra that ``pdif`` (tools/pdif.py, a byte-parity port of
the reference's file_dif.c) actually parses — so the real converter
and the unmodified tutorial pipeline run on it end to end.

The classification task is honest XRD-shaped physics: every space
group g∈1..230 gets a deterministic set of 8–16 characteristic
diffraction peak positions in 2θ∈[7°,88°]; each sample draws a
Lorentzian-broadened spectrum of those peaks with per-sample position
jitter (~0.1°, about one pdif histogram bin), intensity scaling, peak
width, background slope and counting noise.  Classes are separable
but samples within a class differ everywhere, like real powder
patterns of one structure type.

Determinism: the master seed fixes both the per-class peak tables
(seeded per class, independent of sample count) and the sample stream,
so anyone can regenerate the exact dataset from the seed.

With ``--quirks`` the generator also emits the pathological files the
reference pipeline is known to skip (a Mo-radiation file, a first-line
``5.000`` bailout, an unknown space-group symbol) to exercise pdif's
skip paths at scale.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from hpnn_tpu_torch.tools.sgdata import SG_NUMBER

# first Hermann-Mauguin symbol registered for each IT number 1..230
# (dict preserves the sgdata table's insertion order -> deterministic)
SG_SYMBOL: dict[int, str] = {}
for _sym, _n in SG_NUMBER.items():
    SG_SYMBOL.setdefault(_n, _sym)

GRID_LO, GRID_HI, GRID_STEP = 5.0, 90.0, 0.02


def class_peaks(space: int, seed: int):
    """Deterministic characteristic peaks for one space group:
    (positions [K], relative intensities [K]) with K in 8..16."""
    rng = np.random.RandomState((seed * 1009 + space) % 2**32)
    k = int(rng.randint(8, 17))
    pos = np.sort(rng.uniform(7.0, 88.0, size=k))
    inten = rng.lognormal(mean=0.0, sigma=0.8, size=k)
    inten /= inten.max()
    return pos, inten


def render_spectrum(pos, inten, rng: np.random.RandomState):
    """One noisy raw powder pattern on the fixed 2θ grid."""
    grid = np.arange(GRID_LO, GRID_HI + GRID_STEP / 2, GRID_STEP)
    jpos = pos + rng.normal(0.0, 0.10, size=pos.shape)
    jint = inten * rng.uniform(0.6, 1.4, size=inten.shape)
    gamma = rng.uniform(0.06, 0.18)  # Lorentzian HWHM, degrees
    scale = rng.uniform(2000.0, 20000.0)
    y = np.zeros_like(grid)
    for p, a in zip(jpos, jint):
        y += a / (1.0 + ((grid - p) / gamma) ** 2)
    y *= scale
    # sloping fluorescence background + counting noise
    y += rng.uniform(20.0, 120.0) * (1.0 - (grid - GRID_LO) / (GRID_HI - GRID_LO))
    y += rng.normal(0.0, np.sqrt(np.maximum(y, 1.0)))
    return grid, np.maximum(y, 0.0), jpos, jint


def write_dif(path, name, space, temp_c, kelvin, cell, peaks, rng):
    sym = SG_SYMBOL[space]
    with open(path, "w") as fp:
        fp.write(f"{name}  SynthMineral{space:03d}  synthetic XRD pattern\n")
        if kelvin:
            fp.write(f"   Sample was measured at T = {temp_c + 273.15:.1f} K\n")
        else:
            fp.write(f"   Sample was measured at T = {temp_c:.0f} C\n")
        fp.write(
            "   CELL PARAMETERS: %8.4f %8.4f %8.4f %8.3f %8.3f %8.3f\n" % cell
        )
        fp.write(f"   SPACE GROUP: {sym}\n")
        fp.write("   X-RAY WAVELENGTH: 1.541838\n")
        fp.write("            2-THETA      INTENSITY\n")
        jpos, jint = peaks
        for p, a in zip(jpos, jint):
            fp.write("%12.2f %14.2f\n" % (p, 100.0 * a))
        fp.write("\n")
        fp.write("================================\n")


def write_raw(path, name, grid, spectrum):
    with open(path, "w") as fp:
        fp.write(f"## {name} synthetic raw powder pattern\n")
        fp.write("## two-theta  intensity\n")
        for t, v in zip(grid, spectrum):
            fp.write("%.2f %.2f\n" % (t, v))


def write_quirk_files(dif_dir, raw_dir, rng):
    """Files the reference pipeline skips; pdif must skip them too."""
    grid = np.arange(GRID_LO, GRID_HI + GRID_STEP / 2, GRID_STEP)
    flat = 50.0 + rng.normal(0.0, 5.0, size=grid.shape)
    # (a) Mo radiation — skipped by wavelength 0.710730
    with open(os.path.join(dif_dir, "RQ00001"), "w") as fp:
        fp.write("RQ00001  MoQuirk  synthetic\n")
        fp.write("   CELL PARAMETERS: 5.0000 5.0000 5.0000 90.000 90.000 90.000\n")
        fp.write("   SPACE GROUP: Pm3m\n")
        fp.write("   X-RAY WAVELENGTH: 0.710730\n")
        fp.write("            2-THETA      INTENSITY\n")
        fp.write("       20.00         100.00\n")
    write_raw(os.path.join(raw_dir, "RQ00001"), "RQ00001", grid, flat)
    # (b) first-line "5.000" bailout
    with open(os.path.join(dif_dir, "RQ00002"), "w") as fp:
        fp.write("RQ00002  measured at 5.000 GPa\n")
        fp.write("   CELL PARAMETERS: 5.0000 5.0000 5.0000 90.000 90.000 90.000\n")
        fp.write("   SPACE GROUP: Pm3m\n")
        fp.write("            2-THETA      INTENSITY\n")
        fp.write("       20.00         100.00\n")
    write_raw(os.path.join(raw_dir, "RQ00002"), "RQ00002", grid, flat)
    # (c) unknown space-group symbol -> space 0 -> all −1 outputs
    with open(os.path.join(dif_dir, "RQ00003"), "w") as fp:
        fp.write("RQ00003  UnknownSG  synthetic\n")
        fp.write("   CELL PARAMETERS: 5.0000 5.0000 5.0000 90.000 90.000 90.000\n")
        fp.write("   SPACE GROUP: Qqqq\n")
        fp.write("            2-THETA      INTENSITY\n")
        fp.write("       20.00         100.00\n")
    write_raw(os.path.join(raw_dir, "RQ00003"), "RQ00003", grid, flat)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="synth_rruff",
        description="deterministic synthetic RRUFF-XRD dif/raw dataset",
    )
    ap.add_argument("out_dir", help="directory for dif/ and raw/ subdirs")
    ap.add_argument("--per-class", type=int, default=16,
                    help="samples per space group (default 16)")
    ap.add_argument("--classes", type=int, default=230,
                    help="number of space groups, 1..N (default 230)")
    ap.add_argument("--seed", type=int, default=10958)
    ap.add_argument("--quirks", action="store_true",
                    help="also emit pathological files pdif must skip")
    args = ap.parse_args(argv)

    dif_dir = os.path.join(args.out_dir, "dif")
    raw_dir = os.path.join(args.out_dir, "raw")
    os.makedirs(dif_dir, exist_ok=True)
    os.makedirs(raw_dir, exist_ok=True)

    rng = np.random.RandomState(args.seed)
    total = args.classes * args.per_class
    sys.stdout.write(
        f"generating {total} synthetic XRD patterns "
        f"({args.classes} space groups x {args.per_class}, seed {args.seed})\n"
    )
    tables = {g: class_peaks(g, args.seed) for g in range(1, args.classes + 1)}
    idx = 0
    for g in range(1, args.classes + 1):
        pos, inten = tables[g]
        for _ in range(args.per_class):
            idx += 1
            name = f"R{idx:06d}"
            grid, spec, jpos, jint = render_spectrum(pos, inten, rng)
            temp_c = float(rng.uniform(15.0, 35.0))
            kelvin = bool(rng.rand() < 0.2)
            cell = tuple(np.concatenate([
                rng.uniform(3.0, 15.0, size=3),
                rng.uniform(60.0, 120.0, size=3),
            ]))
            write_dif(os.path.join(dif_dir, name), name, g, temp_c, kelvin,
                      cell, (jpos, jint), rng)
            write_raw(os.path.join(raw_dir, name), name, grid, spec)
    if args.quirks:
        write_quirk_files(dif_dir, raw_dir, rng)
    sys.stdout.write(f"wrote dif/raw pairs into {args.out_dir}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``pmnist`` — MNIST idx files → one text sample file per digit.

Byte-compatible with the reference converter
(ref: libhpnn tutorials/mnist/prepare_mnist.c):

* reads ``./train_labels``/``./train_images`` and
  ``./test_labels``/``./test_images`` (the renamed idx files) from the
  current directory;
* writes ``s%05d.txt`` per image — pixels UNNORMALIZED 0–255 as
  ``%7.5f`` (ref: prepare_mnist.c:49-52), labels one-hot in {−1,1}
  with a ``  #<label>`` comment on the ``[output]`` line
  (ref: prepare_mnist.c:53-59);
* the file index CONTINUES across the train→test boundary (the
  reference never resets ``index``), so tests are s60001.txt onward.

Conscious fix vs the reference: prepare_mnist.c's test section reads
the first label twice (the duplicated ``_READ(label_f,data.label)`` at
prepare_mnist.c:228-230), which shifts every test label by one and
drops the last test image — systematically mislabeling the whole test
set.  This converter pairs label[i] with image[i] for both sets.
"""

from __future__ import annotations

import os
import struct
import sys


def _read_idx_images(path: str):
    with open(path, "rb") as fp:
        magic, size, rows, cols = struct.unpack(">IIII", fp.read(16))
        data = fp.read(size * rows * cols)
    return magic, size, rows, cols, data


def _read_idx_labels(path: str):
    with open(path, "rb") as fp:
        magic, size = struct.unpack(">II", fp.read(8))
        data = fp.read(size)
    return magic, size, data


def write_output(fp, pixels: bytes, label: int) -> None:
    """One sample, byte-for-byte the reference's ``write_output``."""
    fp.write("[input] %i\n" % len(pixels))
    fp.write(" ".join("%7.5f" % float(p) for p in pixels))
    fp.write("\n")
    fp.write("[output] %i  #%d\n" % (10, label))
    fp.write(" ".join("1.0" if label == i else "-1.0" for i in range(10)))
    fp.write("\n")


def _convert(label_nm: str, image_nm: str, out_dir: str, start_index: int,
             what: str) -> int:
    try:
        lmagic, lsize, labels = _read_idx_labels(label_nm)
    except OSError:
        sys.stderr.write(f"FAILED to open label file {label_nm} for READ!\n")
        return -1
    try:
        imagic, isize, rows, cols, images = _read_idx_images(image_nm)
    except OSError:
        sys.stderr.write(f"FAILED to open image file {image_nm} for READ!\n")
        return -1
    if lsize != isize:
        sys.stderr.write(
            f"ERROR: different set size!\n-- {label_nm} has {lsize} "
            f"and {image_nm} has {isize}"
        )
        return -1
    sys.stdout.write(f"# Opened {what} label={lmagic:X} image={imagic:X}\n")
    n_px = rows * cols
    if n_px == 0:
        sys.stderr.write(f"ERROR: pixel size is 0: rows={rows} cols={cols}!\n")
        return -1
    index = start_index
    for i in range(lsize):
        index += 1
        label = labels[i]
        if label > 9:
            sys.stderr.write("ERROR: label out of boundaries!\n")
            continue
        with open(os.path.join(out_dir, f"s{index:05d}.txt"), "w") as fp:
            write_output(fp, images[i * n_px : (i + 1) * n_px], label)
    return index


def dump_help() -> None:
    w = sys.stdout.write
    w("********************************************\n")
    w("usage: pmnist samples_dir tests_dir         \n")
    w("********************************************\n")
    w("samples_dir: where the training samples will\n")
    w("be written.\n")
    w("tests_dir: where the testing samples will be\n")
    w("written.\n")
    w("********************************************\n")
    w("The default MNIST files should be renamed to\n")
    w("train_images from    train-images-idx3-ubyte\n")
    w("train_labels from    train-labels-idx1-ubyte\n")
    w("test_images  from     t10k-images-idx3-ubyte\n")
    w("test_labels  from     t10k-labels-idx1-ubyte\n")
    w("********************************************\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0].startswith("-"):
        if argv[0] in ("-h", "--h", "--help"):
            dump_help()
            return 0
        sys.stderr.write("ERROR invalid argument!\n")
    if len(argv) < 2:
        sys.stderr.write("ERROR not enough arguments!\n")
        dump_help()
        return 1
    sample_wd, test_wd = argv[0], argv[1]
    sys.stdout.write(f"processing sample database into {sample_wd} directory.\n")
    sys.stdout.write(f"processing   test database into {test_wd} directory.\n")
    index = _convert("./train_labels", "./train_images", sample_wd, 0, "samples")
    if index < 0:
        return -1
    if _convert("./test_labels", "./test_images", test_wd, index, "tests") < 0:
        return -1
    return 0


if __name__ == "__main__":
    sys.exit(main())

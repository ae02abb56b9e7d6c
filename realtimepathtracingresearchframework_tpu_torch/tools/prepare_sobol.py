"""Sobol direction-matrix generator + inversion-tile builder.

The reference regenerates its Sobol tables with
``rendering/tools/prepare_sobol.cpp``: it formats the direction
matrices and computes a 2-D INVERSION tile (point index as a function
of the quantized (x, y) Sobol sample of two dimensions) that Z-order
shuffling consumes. Its matrix data is the classic Joe-Kuo construction
("Constructing Sobol sequences with better two-dimensional
projections", SIAM J. Sci. Comput. 30, 2008), where each dimension is
defined by a COMPACT source — a primitive polynomial degree ``s``,
coefficient bits ``a`` and ``s`` odd initial direction integers
``m_1..m_s`` — expanded by the GF(2) recurrence

    m_k = m_{k-s} ^ (m_{k-s} << s) ^ XOR_{i=1..s-1} ((a >> (s-1-i)) & 1) * (m_{k-i} << i)

into matrix columns ``v_j = m_j << (32 - j)``.

This tool implements BOTH directions:
- ``generate_matrices(source, bits)`` expands compact (s, a, m) source
  rows into full direction matrices (the actual generator the reference
  tool presumes);
- ``extract_source(matrices)`` recovers the compact source FROM a
  matrix table by inverting the recurrence (searching the polynomial
  per dimension), so the shipped ``pointset_tables.npz`` is itself the
  source archive — no network fetch of the Joe-Kuo data file needed.
- ``inversion_tile(matrices, tile_size, dim_x, dim_y)`` reproduces
  prepare_sobol.cpp:37-62 exactly (evaluate the 2-D Sobol point for
  every index, quantize to tile_bits, invert y*tile+x -> index).

Round-tripping extract -> generate over all 1024 dims and regenerating
the shipped 256x256 inversion tile are asserted bit-exact in
``tests/test_tools.py`` and, for this copy, ``tests/test_torch_tools.py``.

Usage:
  python -m realtimepathtracingresearchframework_tpu_torch.tools.prepare_sobol \
      [--tile-size 256] [--dims DX DY] [--source out.txt] [--npz out.npz]

With ``--source`` it writes the compact source in the Joe-Kuo file
format (``d s a m_1 ... m_s`` per line); with ``--npz`` it writes a
freshly GENERATED matrix + inversion tile table (byte-compatible with
the sobol_matrix/sobol_invert entries of pointset_tables.npz).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from realtimepathtracingresearchframework_tpu_torch.ops.pointsets_tables import (
    _tables_np,
)

MATRIX_BITS = 32

# the largest primitive-polynomial degree the 21201-dim Joe-Kuo table
# uses is 18; extraction failing below this means the input is not a
# Joe-Kuo matrix at all (caps the candidate search at 2^17)
MAX_DEGREE = 18

# dimension 1 is van der Corput (v_j = 1 << (bits - j), i.e. m_j = 1
# for all j) — it precedes the recurrence in the Joe-Kuo construction
# and is encoded as the sentinel source row (0, 0, []) here
VDC = (0, 0, [])


def generate_dimension(s: int, a: int, m_init, bits: int = MATRIX_BITS):
    """Direction integers m_1..m_bits for one dimension from its compact
    Joe-Kuo source; the VDC sentinel yields the van der Corput row."""
    if s == 0:
        return np.ones(bits, np.uint64)
    m = list(int(v) for v in m_init)
    assert len(m) == s
    for k in range(s, bits):
        new = m[k - s] ^ (m[k - s] << s)
        for i in range(1, s):
            if (a >> (s - 1 - i)) & 1:
                new ^= m[k - i] << i
        m.append(new)
    return np.array(m[:bits], np.uint64)


def generate_matrices(source, bits: int = MATRIX_BITS) -> np.ndarray:
    """(dims, bits) uint32 direction matrices, v_j = m_j << (bits - j).
    ``source`` is a list of (s, a, m_init) compact rows, first row =
    dimension 1."""
    out = np.zeros((len(source), bits), np.uint32)
    for d, (s, a, m_init) in enumerate(source):
        m = generate_dimension(s, a, m_init, bits)
        j = np.arange(1, bits + 1, dtype=np.uint64)
        out[d] = ((m << (np.uint64(bits) - j)) & np.uint64(0xFFFFFFFF)).astype(
            np.uint32
        )
    return out


def extract_source(matrices: np.ndarray):
    """Recover the compact (s, a, m_init) source from (dims, 32) uint32
    direction matrices by searching, per dimension, the polynomial
    (degree + coefficients) whose recurrence reproduces every column.
    The m_j are exact for j <= 32 (m_j = v_j >> (32 - j)); candidate
    coefficient vectors are filtered vectorized against m_{s+1} first,
    then fully verified."""
    bits = matrices.shape[1]
    j = np.arange(1, bits + 1, dtype=np.uint64)
    source = []
    for d in range(matrices.shape[0]):
        m = (matrices[d].astype(np.uint64) >> (np.uint64(bits) - j)).astype(
            np.int64
        )
        if np.all(m == 1):  # van der Corput (dimension 1)
            source.append(VDC)
            continue
        found = None
        for s in range(1, min(MAX_DEGREE, bits) + 1):
            if found:
                break
            # all Joe-Kuo m_i are odd; a cheap sanity gate
            if not all(int(m[i]) & 1 for i in range(s)):
                continue
            n_a = 1 << max(s - 1, 0)
            cand = np.arange(n_a, dtype=np.int64)
            # predicted m_{s+1} for every candidate a (vectorized)
            pred = np.full(n_a, int(m[0]) ^ (int(m[0]) << s), np.int64)
            for i in range(1, s):
                bit = (cand >> (s - 1 - i)) & 1
                pred ^= bit * (int(m[s - i]) << i)
            ok = np.nonzero(pred == int(m[s]))[0] if s < bits else cand
            for a in ok:
                mm = generate_dimension(
                    s, int(a), [int(v) for v in m[:s]], bits
                )
                if np.array_equal(mm.astype(np.int64), m):
                    found = (s, int(a), [int(v) for v in m[:s]])
                    break
        if found is None:
            raise ValueError(f"dimension {d}: no primitive recurrence found")
        source.append(found)
    return source


def sobol_point_u32(matrices: np.ndarray, index, dim: int) -> np.ndarray:
    """32-bit Sobol sample of ``dim`` at ``index`` (vectorized), the
    XOR-of-columns evaluation prepare_sobol.cpp:42-50 uses."""
    index = np.asarray(index, np.uint64)
    out = np.zeros(index.shape, np.uint32)
    for i in range(matrices.shape[1]):
        bit = ((index >> np.uint64(i)) & np.uint64(1)).astype(bool)
        out = np.where(bit, out ^ matrices[dim, i], out)
    return out


def inversion_tile(matrices: np.ndarray, tile_size: int = 256,
                   dim_x: int = 0, dim_y: int = 1) -> np.ndarray:
    """(tile, tile) uint32 table mapping quantized (y, x) Sobol samples
    back to the point index — prepare_sobol.cpp:31-62 bit-for-bit
    (truncating >> quantization, last writer wins on collisions; with
    the Joe-Kuo (0,1) pair the map is a bijection, so none occur)."""
    tile_bits = int(tile_size - 1).bit_length()
    n = tile_size * tile_size
    idx = np.arange(n, dtype=np.uint64)
    rx = sobol_point_u32(matrices, idx, dim_x) >> np.uint32(32 - tile_bits)
    ry = sobol_point_u32(matrices, idx, dim_y) >> np.uint32(32 - tile_bits)
    table = np.zeros(n, np.uint32)
    table[(ry.astype(np.int64) * tile_size + rx.astype(np.int64))] = (
        idx.astype(np.uint32)
    )
    return table.reshape(tile_size, tile_size)


def write_joe_kuo_file(source, path: str) -> None:
    """Compact source in the Joe-Kuo new-joe-kuo-6 text layout:
    ``d s a m_1 .. m_s`` (dimension 1's trivial row is left implicit,
    as in the published file)."""
    with open(path, "w") as f:
        f.write("d       s       a       m_i\n")
        for d, (s, a, m) in enumerate(source[1:], start=2):
            f.write(f"{d}       {s}       {a}       "
                    + " ".join(str(v) for v in m) + "\n")


def read_joe_kuo_file(path: str):
    """Inverse of write_joe_kuo_file; prepends the implicit dimension-1
    row (s=1, a=0, m=[1])."""
    source = [VDC]
    with open(path) as f:
        next(f)  # header
        for line in f:
            parts = line.split()
            if not parts:
                continue
            s, a = int(parts[1]), int(parts[2])
            source.append((s, a, [int(v) for v in parts[3:3 + s]]))
    return source


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile-size", type=int, default=256)
    ap.add_argument("--dims", type=int, nargs=2, default=(0, 1),
                    metavar=("DX", "DY"))
    ap.add_argument("--source", help="write compact Joe-Kuo source file")
    ap.add_argument("--npz", help="write generated matrix+tile npz")
    ap.add_argument("--from-source",
                    help="generate from a Joe-Kuo source file instead of "
                         "extracting from the shipped tables")
    args = ap.parse_args(argv)

    if args.from_source:
        source = read_joe_kuo_file(args.from_source)
    else:
        shipped = np.asarray(_tables_np()["sobol_matrix"], np.uint32)
        print(f"extracting compact source from shipped "
              f"{shipped.shape[0]}-dim matrix table...")
        source = extract_source(shipped)
    mats = generate_matrices(source)
    print(f"generated {mats.shape[0]} x {mats.shape[1]} direction matrix")
    tile = inversion_tile(mats, args.tile_size, *args.dims)
    zeros = int((tile == 0).sum())
    tile_bits = int(args.tile_size - 1).bit_length()
    print(f"// Tile bits: {tile_bits}; Dimensions: {args.dims[0]} "
          f"{args.dims[1]}; Zeros: {zeros}")

    if args.source:
        write_joe_kuo_file(source, args.source)
        print(f"wrote {args.source}")
    if args.npz:
        np.savez_compressed(
            args.npz, sobol_matrix=mats, sobol_invert=tile
        )
        print(f"wrote {args.npz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

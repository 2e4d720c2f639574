"""b-bit MinHash: keep only the b lowest bits of each MinHash slot.

A copy of ``datasketch_tpu/models/b_bit_minhash.py`` (the JAX package's
module imports no JAX, but the port imports nothing of that package):
the Li & König estimator with the A(r, b) / C1 / C2 correction, and the
reference's pickled form, a ``<qBdi`` header and uint64 blocks of
bit-packed slots, byte for byte. It takes any object with ``hashvalues``
and ``seed``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["bBitMinHash"]


class bBitMinHash:
    """The b-bit MinHash object.

    Args:
        minhash: A full MinHash (any object with ``hashvalues`` and ``seed``)
            to compress.
        b: Bits kept per hash value, in [0, 32].
        r: Expected density parameter for the unbiased estimator.
    """

    __slots__ = ("b", "hashvalues", "r", "seed")

    _serial_fmt_params = "<qBdi"  # seed int64, b uint8, r float64, num_perm int32
    _serial_fmt_block = "Q"

    def __init__(self, minhash, b=1, r=0.0):
        b = int(b)
        r = float(r)
        if b > 32 or b < 0:
            raise ValueError("b must be an integer in [0, 32]")
        if r > 1.0:
            raise ValueError("r must be a float in [0.0, 1.0]")
        bmask = (1 << b) - 1
        self.hashvalues = np.bitwise_and(
            np.asarray(minhash.hashvalues, dtype=np.uint64), np.uint64(bmask)
        ).astype(np.uint32)
        self.seed = minhash.seed
        self.b = b
        self.r = r

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.seed == other.seed
            and self.b == other.b
            and self.r == other.r
            and np.array_equal(self.hashvalues, other.hashvalues)
        )

    def jaccard(self, other: "bBitMinHash") -> float:
        """Unbiased estimate ``(raw - C1) / (1 - C2)``
        (b_bit_minhash.py:53-72)."""
        if self.b != other.b:
            raise ValueError("Cannot compare two b-bit MinHashes with different b values")
        if self.seed != other.seed:
            raise ValueError(
                "Cannot compare two b-bit MinHashes with different set of permutations"
            )
        intersection = np.count_nonzero(self.hashvalues == other.hashvalues)
        raw_est = float(intersection) / float(self.hashvalues.size)
        a1 = self._calc_a(self.r, self.b)
        a2 = self._calc_a(other.r, other.b)
        c1, c2 = self._calc_c(a1, a2, self.r, other.r)
        return (raw_est - c1) / (1 - c2)

    def bytesize(self) -> int:
        return self._bytesize()[-1]

    # ---------------------------------------------------------------- packing

    def __getstate__(self):
        slot_size, n, num_blocks, total = self._bytesize()
        buffer = bytearray(total)
        hv = self.hashvalues.astype(np.uint64)
        padded = np.zeros(num_blocks * n, dtype=np.uint64)
        padded[: hv.size] = hv
        shifts = ((n - 1 - np.arange(n)) * slot_size).astype(np.uint64)
        blocks = np.bitwise_or.reduce(
            padded.reshape(num_blocks, n) << shifts[None, :], axis=1
        )
        fmt = self._serial_fmt_params + "%d%s" % (num_blocks, self._serial_fmt_block)
        struct.pack_into(
            fmt, buffer, 0, self.seed, self.b, self.r, self.hashvalues.size, *blocks
        )
        return buffer

    def __setstate__(self, buf):
        mv = memoryview(buf)
        self.seed, self.b, self.r, num_perm = struct.unpack_from(
            self._serial_fmt_params, mv, 0
        )
        offset = struct.calcsize(self._serial_fmt_params)
        self.hashvalues = np.zeros((num_perm,), dtype=np.uint32)
        slot_size, n, num_blocks, _total = self._bytesize()
        fmt = "%d%s" % (num_blocks, self._serial_fmt_block)
        blocks = np.array(struct.unpack_from(fmt, mv, offset), dtype=np.uint64)
        shifts = ((n - 1 - np.arange(n)) * slot_size).astype(np.uint64)
        mask = np.uint64((1 << slot_size) - 1)
        slots = (blocks[:, None] >> shifts[None, :]) & mask
        self.hashvalues = slots.reshape(-1)[:num_perm].astype(np.uint32)

    # ---------------------------------------------------------------- helpers

    def _calc_a(self, r, b):
        """A(r, b) of the Li & König estimator (limit 2^-b as r -> 0)."""
        if r == 0.0:
            return 1.0 / (1 << b)
        return r * (1 - r) ** (2**b - 1) / (1 - (1 - r) ** (2 * b))

    def _calc_c(self, a1, a2, r1, r2):
        if r1 == 0.0 and r2 == 0.0:
            return a1, a2
        div = 1 / (r1 + r2)
        c1 = (a1 * r2 + a2 * r1) * div
        c2 = (a1 * r1 + a2 * r2) * div
        return c1, c2

    def _find_slot_size(self, b):
        # exact ladder of b_bit_minhash.py:147-160 (note b=0 lands on 4)
        if b == 1:
            return 1
        if b == 2:
            return 2
        for limit in (4, 8, 16, 32):
            if b <= limit:
                return limit
        raise ValueError("Incorrect value of b")

    def _bytesize(self):
        block_size = struct.calcsize(self._serial_fmt_block)
        slot_size = self._find_slot_size(self.b)
        num_slots_per_block = int(block_size * 8 / slot_size)
        num_blocks = int(np.ceil(float(self.hashvalues.size) / num_slots_per_block))
        total = struct.calcsize(
            self._serial_fmt_params + "%d%s" % (num_blocks, self._serial_fmt_block)
        )
        return slot_size, num_slots_per_block, num_blocks, total

"""LeanMinHash -- frozen, compact MinHash with a portable byte format.

A copy of ``datasketch_tpu/models/lean_minhash.py`` on the port's
:class:`~datasketch_tpu_torch.models.minhash.MinHash`: ``__slots__`` state
(seed, hashvalues), no permutations or hashfunc, ``update`` raises
TypeError, and the byte layout is ``seed:int64, length:int32,
hashvalues:uint32[length]`` under a selectable struct byte order, so a
buffer serialized by either package (or the reference) deserializes in the
others.
"""

from __future__ import annotations

import struct

import numpy as np

from datasketch_tpu_torch.models.minhash import MinHash

__all__ = ["LeanMinHash"]


class LeanMinHash(MinHash):
    """A frozen MinHash: smaller memory footprint, binary-serializable.

    Construct from an existing :class:`MinHash` or from (seed, hashvalues).
    All read-only MinHash methods (jaccard, count, merge targets, LSH
    insertion) work; ``update`` does not.
    """

    __slots__ = ("hashvalues", "seed")

    def _initialize_slots(self, seed, hashvalues):
        self.seed = seed
        self.hashvalues = self._parse_hashvalues(hashvalues)

    def __init__(self, minhash=None, seed=None, hashvalues=None):
        if minhash is not None:
            self._initialize_slots(minhash.seed, minhash.hashvalues)
        elif hashvalues is not None and seed is not None:
            self._initialize_slots(seed, hashvalues)
        else:
            raise ValueError(
                "Init parameters cannot be None: make sure to set either "
                "minhash or both of hash values and seed"
            )

    def update(self, b) -> None:
        raise TypeError("Cannot update a LeanMinHash")

    def update_batch(self, b) -> None:
        raise TypeError("Cannot update a LeanMinHash")

    def copy(self) -> "LeanMinHash":
        lmh = object.__new__(LeanMinHash)
        lmh._initialize_slots(self.seed, self.hashvalues)
        return lmh

    def bytesize(self, byteorder: str = "@") -> int:
        """Serialized size in bytes: 8 (seed) + 4 (count) + 4 per value."""
        seed_size = struct.calcsize(byteorder + "q")
        length_size = struct.calcsize(byteorder + "i")
        hashvalue_size = struct.calcsize(byteorder + "I")
        return seed_size + length_size + len(self) * hashvalue_size

    def serialize(self, buf, byteorder: str = "@") -> None:
        """Write the binary form into a pre-allocated writable buffer.

        Layout: seed int64, count int32, then ``count`` uint32 hash
        values, all under ``byteorder``.
        """
        if len(buf) < self.bytesize():
            raise ValueError(
                "The buffer does not have enough space for holding this MinHash."
            )
        fmt = "%sqi%dI" % (byteorder, len(self))
        struct.pack_into(fmt, buf, 0, self.seed, len(self), *self.hashvalues)

    @classmethod
    def deserialize(cls, buf, byteorder: str = "@") -> "LeanMinHash":
        """Reconstruct a LeanMinHash from its binary form."""
        fmt_seed_size = "%sqi" % byteorder
        fmt_hash = byteorder + "%dI"
        mv = memoryview(buf)
        seed, num_perm = struct.unpack_from(fmt_seed_size, mv, 0)
        offset = struct.calcsize(fmt_seed_size)
        hashvalues = struct.unpack_from(fmt_hash % num_perm, mv, offset)
        lmh = object.__new__(LeanMinHash)
        lmh._initialize_slots(seed, hashvalues)
        return lmh

    def __getstate__(self):
        buf = bytearray(self.bytesize())
        self.serialize(buf, "@")
        return buf

    def __setstate__(self, buf):
        mv = memoryview(buf)
        seed, num_perm = struct.unpack_from("qi", mv, 0)
        offset = struct.calcsize("qi")
        hashvalues = struct.unpack_from("%dI" % num_perm, mv, offset)
        self._initialize_slots(seed, hashvalues)

    def __hash__(self) -> int:
        return hash((self.seed, tuple(self.hashvalues)))

    @classmethod
    def union(cls, *lmhs: "LeanMinHash") -> "LeanMinHash":
        """Union multiple LeanMinHash into a new one (elementwise min)."""
        if len(lmhs) < 2:
            raise ValueError("Cannot union less than 2 MinHash")
        num_perm = len(lmhs[0])
        seed = lmhs[0].seed
        if any((seed != m.seed or num_perm != len(m)) for m in lmhs):
            raise ValueError(
                "The unioning MinHash must have the same seed, number of "
                "permutation functions."
            )
        hashvalues = np.minimum.reduce([m.hashvalues for m in lmhs])
        lmh = object.__new__(LeanMinHash)
        lmh._initialize_slots(seed, hashvalues)
        return lmh

"""MinHashLSHForest -- approximate top-k Jaccard index on the host.

A copy of ``datasketch_tpu/models/lshforest.py`` (numpy only), with the
reference forest's API (add / index / query / get_minhash_hashvalues /
is_empty / __contains__): sorted byte-prefix keys per tree, every prefix
lookup a NumPy ``searchsorted`` over a fixed-width bytes array (the ``S``
dtype compares bytewise, which matches the byteswapped key encoding),
batched across queries in :meth:`query_batch`. The forest on the card is
:class:`~datasketch_tpu_torch.models.torch_forest.TorchMinHashLSHForest`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Hashable

import numpy as np

__all__ = ["MinHashLSHForest"]


class MinHashLSHForest:
    """LSH Forest for top-k Jaccard queries (works with MinHash and
    WeightedMinHash alike).

    Args:
        num_perm: Signature length of the sketches to be indexed.
        l: Number of prefix trees; each tree consumes ``k = num_perm // l``
            hash values.
    """

    def __init__(self, num_perm: int = 128, l: int = 8) -> None:
        if l <= 0 or num_perm <= 0:
            raise ValueError("num_perm and l must be positive")
        if l > num_perm:
            raise ValueError("l cannot be greater than num_perm")
        self.l = l
        self.k = int(num_perm / l)
        self.hashtables = [defaultdict(list) for _ in range(self.l)]
        self.hashranges = [(i * self.k, (i + 1) * self.k) for i in range(self.l)]
        self.keys: dict = {}
        # sorted arrays standing in for prefix trees
        self.sorted_hashtables = [[] for _ in range(self.l)]
        # fixed-width bytes mirrors of sorted_hashtables for vectorized
        # searchsorted (rebuilt by index())
        self._sorted_arrays = [None] * self.l

    def _H(self, hs) -> bytes:
        # preserve native dtype: WeightedMinHash rows are signed (k, t) pairs
        return bytes(np.asarray(hs).byteswap().data)

    def add(self, key: Hashable, minhash) -> None:
        """Stage (key, minhash); not searchable until :meth:`index`."""
        if len(minhash) < self.k * self.l:
            raise ValueError("The num_perm of MinHash out of range")
        if key in self.keys:
            raise ValueError("The given key has already been added")
        self.keys[key] = [
            self._H(minhash.hashvalues[start:end]) for start, end in self.hashranges
        ]
        for H, hashtable in zip(self.keys[key], self.hashtables):
            hashtable[H].append(key)

    def index(self) -> None:
        """Sort each table's keys, making everything staged searchable."""
        for i, hashtable in enumerate(self.hashtables):
            self.sorted_hashtables[i] = sorted(hashtable)
            if self.sorted_hashtables[i]:
                width = len(self.sorted_hashtables[i][0])
                self._sorted_arrays[i] = np.array(
                    self.sorted_hashtables[i], dtype="S%d" % width
                )
            else:
                self._sorted_arrays[i] = np.empty(0, dtype="S1")

    def _tree_runs(self, hp_matrix, r: int):
        """Run bounds per (tree, query) for r-length prefixes.

        Args:
            hp_matrix: list (len l) of lists (len Q) of prefix bytes.
        Returns:
            per tree: (lo int[Q], hi int[Q]) — slice bounds into
            ``sorted_hashtables[tree]`` whose keys carry the prefix.
        """
        out = []
        for tree, prefixes in enumerate(hp_matrix):
            arr = self._sorted_arrays[tree]
            if arr is None or arr.size == 0:
                z = np.zeros(len(prefixes), dtype=np.intp)
                out.append((z, z))
                continue
            width = arr.dtype.itemsize
            pad = width - len(prefixes[0])
            # fixed-width S compares with implicit null padding, so the
            # prefix itself is the smallest key carrying it and
            # prefix+0xff.. the largest
            lo = np.searchsorted(arr, np.array(prefixes, dtype=arr.dtype))
            ceil = np.array(
                [p + b"\xff" * pad for p in prefixes], dtype=arr.dtype
            )
            hi = np.searchsorted(arr, ceil, side="right")
            out.append((lo, hi))
        return out

    def _prefixes(self, hashvalue_rows, r: int):
        """Byteswapped r-prefix per tree per query: l x Q bytes lists."""
        return [
            [self._H(hv[start : start + r]) for hv in hashvalue_rows]
            for start, _ in self.hashranges
        ]

    def _query(self, minhash, r, b):
        """Yield keys whose r-length prefix matches in any of the first b
        trees (vectorized searchsorted; bucket iteration keeps the
        reference's tree-then-run order)."""
        if r > self.k or r <= 0 or b > self.l or b <= 0:
            raise ValueError("parameter outside range")
        runs = self._tree_runs(self._prefixes([minhash.hashvalues], r), r)
        for tree in range(b):
            lo, hi = runs[tree]
            ht, table = self.sorted_hashtables[tree], self.hashtables[tree]
            for bk in ht[int(lo[0]) : int(hi[0])]:
                yield from table[bk]

    def query(self, minhash, k: int) -> list:
        """Approximate top-k most-similar keys: descend prefix length from
        self.k until at least k results collected."""
        return self.query_batch([minhash], k)[0]

    def query_batch(self, minhashes, k: int) -> list:
        """Top-k for many queries at once.

        One vectorized two-sided ``searchsorted`` per (tree, prefix level)
        covers the whole batch; per-query candidate collection then follows
        the reference's exact iteration order (trees in order, run items in
        sorted order, early-stop at k), so ``query_batch(ms, k)[i] ==
        query(ms[i], k)`` element for element.
        """
        if k <= 0:
            raise ValueError("k must be positive")
        minhashes = list(minhashes)
        for m in minhashes:
            if len(m) < self.k * self.l:
                raise ValueError("The num_perm of MinHash out of range")
        results = [set() for _ in minhashes]
        done = [False] * len(minhashes)
        rows = [m.hashvalues for m in minhashes]
        for r in range(self.k, 0, -1):
            active = [i for i in range(len(minhashes)) if not done[i]]
            if not active:
                break
            runs = self._tree_runs(
                self._prefixes([rows[i] for i in active], r), r
            )
            for tree in range(self.l):
                lo, hi = runs[tree]
                ht, table = self.sorted_hashtables[tree], self.hashtables[tree]
                for qi, l_, h_ in zip(active, lo, hi):
                    if done[qi]:
                        continue
                    res = results[qi]
                    for bk in ht[int(l_) : int(h_)]:
                        for key in table[bk]:
                            res.add(key)
                            if len(res) >= k:
                                done[qi] = True
                                break
                        if done[qi]:
                            break
        return [list(res) for res in results]

    def get_minhash_hashvalues(self, key: Hashable) -> np.ndarray:
        """Reconstruct the indexed MinHash's hashvalues from the stored
        byte-swapped prefixes."""
        byteslist = self.keys.get(key, None)
        if byteslist is None:
            raise KeyError(f"The provided key does not exist in the LSHForest: {key}")
        hashvalue_byte_size = len(byteslist[0]) // 8
        hashvalues = np.empty(len(byteslist) * hashvalue_byte_size, dtype=np.uint64)
        for index, item in enumerate(byteslist):
            hv_segment = np.frombuffer(item, dtype=np.uint64).byteswap()
            curr = index * hashvalue_byte_size
            hashvalues[curr : curr + hashvalue_byte_size] = hv_segment
        return hashvalues

    def is_empty(self) -> bool:
        """True until :meth:`index` has made at least one key searchable."""
        return any(len(t) == 0 for t in self.sorted_hashtables)

    def __contains__(self, key: Hashable) -> bool:
        return key in self.keys

"""HyperLogLog / HyperLogLog++: cardinality sketches.

Port of ``datasketch_tpu/models/hyperloglog.py``: ``update``, ``count``,
``merge``, ``union``, ``digest``, ``serialize`` / ``deserialize`` and
pickling, equal to the JAX package's (and the reference's) byte for byte.
The batch paths hash on the host (the native SHA1 batch hasher for the
stock hash functions) and scatter ranks into the registers either there
(the native ``hll_scatter``) or on ``device`` (:mod:`datasketch_tpu_torch.
ops.hll_ops`, per ``device_mode``). The HLL++ empirical bias tables are the
published constants of the HLL++ paper's appendix, shipped as
``_hllpp_bias.npz`` (a copy of the JAX package's).
"""

from __future__ import annotations

import copy
import functools
import itertools
import os
import struct
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from datasketch_tpu_torch import native
from datasketch_tpu_torch.device import resolve_device, upload_bits
from datasketch_tpu_torch.hashfunc import (
    batch_sha1_hash32,
    batch_sha1_hash64,
    device_hash,
    device_hash64,
    sha1_hash32,
    sha1_hash64,
)
from datasketch_tpu_torch.ops import hll_ops
from datasketch_tpu_torch.ops.hashing import mix32_np, mix64_np

__all__ = ["HyperLogLog", "HyperLogLogPlusPlus"]


@functools.lru_cache(maxsize=1)
def _bias_tables():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_hllpp_bias.npz")
    data = np.load(path)
    thresholds = data["thresholds"]
    raw_estimate = {p: data[f"raw_estimate_{p}"] for p in range(4, 19)}
    bias = {p: data[f"bias_{p}"] for p in range(4, 19)}
    return thresholds, raw_estimate, bias


def _use_device(mode: str, n_tokens: int, threshold: int) -> bool:
    return mode == "always" or (mode == "auto" and n_tokens >= threshold)


class HyperLogLog:
    """HyperLogLog sketch for one-pass cardinality estimation.

    Args:
        p: precision in [4, 16]; the sketch keeps ``m = 2**p`` registers.
        reg: optional existing register array (adopts its precision).
        hashfunc: token hash returning an int of at most 32 bits;
            ``"device"`` marks integer token ids (fmix32).
        hashobj: deprecated, ignored.
        device_mode: ``"disable"`` | ``"auto"`` | ``"always"``: whether
            :meth:`update_batch` and :meth:`bulk_registers` scatter on
            ``device`` (``"auto"``: batches of 32,768 tokens or more).
        device: where that runs: ``"cuda"`` (default; raises without a
            card of capability >= 9.0) or ``"cpu"``.
    """

    __slots__ = ("alpha", "device", "device_mode", "hashfunc", "m", "max_rank", "p", "reg")

    _hash_range_bit = 32
    _hash_range_byte = 4
    # Below this many tokens the host scatter beats a device dispatch.
    _DEVICE_BATCH_THRESHOLD = 1 << 15

    def _get_alpha(self, p: int) -> float:
        if not (4 <= p <= 16):
            raise ValueError("p=%d should be in range [4 : 16]" % p)
        if p == 4:
            return 0.673
        if p == 5:
            return 0.697
        if p == 6:
            return 0.709
        return 0.7213 / (1.0 + 1.079 / (1 << p))

    def __init__(
        self,
        p: int = 8,
        reg: Optional[np.ndarray] = None,
        hashfunc: Callable = sha1_hash32,
        hashobj: Optional[object] = None,
        device_mode: str = "auto",
        device="cuda",
    ):
        if device_mode not in ("disable", "auto", "always"):
            raise ValueError("device_mode must be 'disable', 'auto' or 'always'")
        self.device_mode = device_mode
        self.device = device
        if reg is None:
            self.p = p
            self.m = 1 << p
            self.reg = np.zeros((self.m,), dtype=np.int8)
        else:
            if not isinstance(reg, np.ndarray):
                raise ValueError("The imported register must be a numpy.ndarray.")
            self.m = reg.size
            self.p = int(self.m).bit_length() - 1
            if 1 << self.p != self.m:
                raise ValueError(
                    "The imported register has incorrect size. Expect a power of 2."
                )
            self.reg = reg
        if hashfunc == "device":
            hashfunc = device_hash64 if self._hash_range_bit == 64 else device_hash
        if not callable(hashfunc):
            raise ValueError("The hashfunc must be a callable.")
        if hashobj is not None:
            warnings.warn(
                "hashobj is deprecated, use hashfunc instead.",
                DeprecationWarning,
                stacklevel=2,
            )
        self.hashfunc = hashfunc
        self.alpha = self._get_alpha(self.p)
        self.max_rank = self._hash_range_bit - self.p

    def update(self, b) -> None:
        """Fold one value into the sketch: register[low p bits of hash]
        takes the max with the leading-zero rank of the remaining bits."""
        hv = self.hashfunc(b)
        reg_index = hv & (self.m - 1)
        bits = hv >> self.p
        self.reg[reg_index] = max(self.reg[reg_index], self._get_rank(bits))

    def update_batch(self, bs) -> None:
        """Fold many values in: hashed on the host, then scattered on
        ``device`` (per ``device_mode``) or on the host."""
        if self.hashfunc is sha1_hash32:
            hv = batch_sha1_hash32(list(bs)).astype(np.int64)
        elif self.hashfunc is device_hash:
            hv = mix32_np(np.asarray(list(bs)).astype(np.uint32)).astype(np.int64)
        else:
            hv = np.array([self.hashfunc(b) for b in bs], dtype=np.int64)
        if hv.size == 0:
            return
        if np.any((hv >> self._hash_range_bit) != 0):
            raise ValueError(
                "Hash value overflow, maximum size is %d bits" % self.max_rank
            )
        if _use_device(self.device_mode, hv.size, self._DEVICE_BATCH_THRESHOLD):
            row = self._device_sketch_rows(
                hv.astype(np.uint64)[None, :], np.array([hv.size], dtype=np.int32)
            )
            np.maximum(self.reg, row.cpu().numpy()[0], out=self.reg)
            return
        # the range check above guarantees rank >= 1, so the fused scatter
        # cannot end in the overflow state; a user-supplied reg= of another
        # dtype or layout takes the numpy path
        if self.reg.dtype == np.int8 and self.reg.flags.c_contiguous and self.reg.flags.writeable:
            native.hll_scatter(
                self.reg, np.ascontiguousarray(hv.astype(np.uint64)),
                np.array([hv.size], dtype=np.int64), self.p, self.max_rank,
            )
            return
        idx = (hv & (self.m - 1)).astype(np.int64)
        ranks = self.max_rank - _np_bit_length(hv >> self.p) + 1
        if np.any(ranks <= 0):
            raise ValueError(
                "Hash value overflow, maximum size is %d bits" % self.max_rank
            )
        np.maximum.at(self.reg, idx, ranks.astype(np.int8))

    def _device_sketch_rows(self, hv: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        """Register rows int8[B, m] on ``device`` of padded uint64 hash
        rows [B, T] (``lengths`` masks the padding)."""
        dev = resolve_device(self.device)
        lens = torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(dev)
        if self._hash_range_bit == 64:
            x = upload_bits(hv.astype(np.uint64), dev)
            return hll_ops.sketch_batch64((x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF, lens, self.p)
        return hll_ops.sketch_batch32(upload_bits(hv.astype(np.uint32), dev), lens, self.p)

    @classmethod
    def bulk_registers(cls, bs, **kwargs) -> np.ndarray:
        """Register matrix of a corpus: int8[N, 2**p] on the host, the
        input of :func:`~datasketch_tpu_torch.ops.hll_ops.count_batch`.

        With ``device_mode="always"`` the ranks are scattered on
        ``device`` in one pass (``hashfunc="device"`` on HLL++ uploads the
        raw ids and hashes them there when every id fits 32 bits); else on
        the host by the native ``hll_scatter``, the stock hash functions
        hashed by the native batch hasher."""
        proto = cls(**kwargs)
        docs = bs if isinstance(bs, list) else list(bs)
        docs = [d if hasattr(d, "__len__") else list(d) for d in docs]
        if not docs:
            return np.zeros((0, proto.m), dtype=np.int8)
        if proto.device_mode == "always":
            if proto.hashfunc is device_hash64:
                # ids wider than 32 bits take the host mix below: the
                # device mix zero-extends 32-bit ids
                arrays = [np.asarray(d, dtype=np.uint64) for d in docs]
                max_id = max((int(a.max()) for a in arrays if a.size), default=0)
                if max_id < (1 << 32):
                    dev = resolve_device(proto.device)
                    ids, lengths = _pad_ids(arrays, max_id)
                    rows = hll_ops.sketch_batch64_ids(
                        upload_bits(ids, dev), torch.from_numpy(lengths).to(dev), proto.p
                    )
                    return rows.cpu().numpy()
            padded, lengths = proto._pad_hash_corpus(docs)
            return proto._device_sketch_rows(padded, lengths).cpu().numpy()
        # host: one fused native pass over (doc, register) pairs
        lengths = np.fromiter(map(len, docs), np.int64, count=len(docs))
        hv = proto._hash_flat(list(itertools.chain.from_iterable(docs)))
        regs = np.zeros((len(docs), proto.m), dtype=np.int8)
        min_rank = native.hll_scatter(
            regs.reshape(-1), np.ascontiguousarray(hv, dtype=np.uint64), lengths,
            proto.p, proto.max_rank,
        )
        if min_rank <= 0:
            raise ValueError(
                "Hash value overflow, maximum size is %d bits" % proto.max_rank
            )
        return regs

    def _hash_flat(self, tokens: list) -> np.ndarray:
        """uint64 hashes of a flat token list: the native batch hasher for
        the stock hash functions, the vectorized mixes for ``"device"``,
        else the callable per token."""
        if not tokens:
            return np.zeros(0, dtype=np.uint64)
        if self.hashfunc is sha1_hash32 and self._hash_range_bit == 32:
            return native.hash_flat(tokens, native.ALGO_SHA1_32).astype(np.uint64)
        if self.hashfunc is sha1_hash64 and self._hash_range_bit == 64:
            return native.hash_flat(tokens, native.ALGO_SHA1_64)
        if self.hashfunc is device_hash:
            return mix32_np(np.asarray(tokens).astype(np.uint32)).astype(np.uint64)
        if self.hashfunc is device_hash64:
            return mix64_np(np.asarray(tokens).astype(np.uint64))
        hv = np.array([self.hashfunc(t) for t in tokens], dtype=np.uint64)
        if np.any((hv >> np.uint64(self._hash_range_bit - 1)) >> 1 != 0):
            raise ValueError(
                "Hash value overflow, maximum size is %d bits" % self.max_rank
            )
        return hv

    @classmethod
    def bulk(cls, bs, **kwargs) -> list:
        """Many sketches at once (the rows of :meth:`bulk_registers`)."""
        regs = cls.bulk_registers(bs, **kwargs)
        kwargs.pop("p", None)
        return [cls(reg=row.copy(), **kwargs) for row in regs]

    def _pad_hash_corpus(self, docs: list):
        """Hashes of every doc, padded: (uint64[B, T], int32[B]) with T the
        longest doc (at least 1)."""
        lengths = np.fromiter(map(len, docs), np.int32, count=len(docs))
        flat = self._hash_flat(list(itertools.chain.from_iterable(docs)))
        t = max(1, int(lengths.max()))
        padded = np.zeros((len(docs), t), dtype=np.uint64)
        padded[np.arange(t)[None, :] < lengths[:, None]] = flat
        return padded, lengths

    def count(self) -> float:
        """Estimate the cardinality seen so far (with the small- and
        large-range corrections)."""
        e = self.alpha * float(self.m**2) / np.sum(2.0 ** (-self.reg))
        small_range_threshold = (5.0 / 2.0) * self.m
        if abs(e - small_range_threshold) / small_range_threshold < 0.15:
            warnings.warn(
                "Warning: estimate is close to error correction threshold. "
                "Output may not satisfy HyperLogLog accuracy guarantee.",
                stacklevel=2,
            )
        if e <= small_range_threshold:
            num_zero = self.m - np.count_nonzero(self.reg)
            return self._linearcounting(num_zero)
        if e <= (1.0 / 30.0) * (1 << 32):
            return e
        return self._largerange_correction(e)

    def merge(self, other: "HyperLogLog") -> None:
        """Union with another sketch: elementwise register max."""
        if self.m != other.m or self.p != other.p:
            raise ValueError("Cannot merge HyperLogLog with different precisions.")
        self.reg = np.maximum(self.reg, other.reg)

    def digest(self) -> np.ndarray:
        return copy.copy(self.reg)

    def copy(self) -> "HyperLogLog":
        return self.__class__(
            reg=self.digest(), hashfunc=self.hashfunc, device_mode=self.device_mode,
            device=self.device,
        )

    def is_empty(self) -> bool:
        return not np.any(self.reg)

    def clear(self) -> None:
        self.reg = np.zeros((self.m,), dtype=np.int8)

    def __len__(self) -> int:
        return len(self.reg)

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.p == other.p
            and self.m == other.m
            and np.array_equal(self.reg, other.reg)
        )

    def _get_rank(self, bits) -> int:
        rank = self.max_rank - int(bits).bit_length() + 1
        if rank <= 0:
            raise ValueError(
                "Hash value overflow, maximum size is %d bits" % self.max_rank
            )
        return rank

    def _linearcounting(self, num_zero):
        return self.m * np.log(self.m / float(num_zero))

    def _largerange_correction(self, e):
        return -(1 << 32) * np.log(1.0 - e / (1 << 32))

    @classmethod
    def union(cls, *hyperloglogs: "HyperLogLog") -> "HyperLogLog":
        if len(hyperloglogs) < 2:
            raise ValueError("Cannot union less than 2 HyperLogLog sketches")
        m = hyperloglogs[0].m
        if not all(h.m == m for h in hyperloglogs):
            raise ValueError("Cannot union HyperLogLog sketches with different precisions")
        reg = np.maximum.reduce([h.reg for h in hyperloglogs])
        return cls(reg=reg, hashfunc=hyperloglogs[0].hashfunc)

    def bytesize(self) -> int:
        """Serialized size: 1 byte for p + 1 byte per register."""
        return struct.calcsize("B") + struct.calcsize("B") * self.m

    def serialize(self, buf) -> None:
        """``B`` p, then the ``m`` register bytes (the reference's layout)."""
        if len(buf) < self.bytesize():
            raise ValueError(
                "The buffer does not have enough space for holding this HyperLogLog."
            )
        struct.pack_into("B%dB" % self.m, buf, 0, self.p, *self.reg)

    @classmethod
    def deserialize(cls, buf) -> "HyperLogLog":
        mv = memoryview(buf)
        p = struct.unpack_from("B", mv, 0)[0]
        h = cls(p)
        offset = struct.calcsize("B")
        h.reg = np.array(struct.unpack_from("%dB" % h.m, mv, offset), dtype=np.int8)
        return h

    def __getstate__(self):
        buf = bytearray(self.bytesize())
        self.serialize(buf)
        return buf

    def __setstate__(self, buf):
        mv = memoryview(buf)
        p = struct.unpack_from("B", mv, 0)[0]
        self.__init__(p=p)
        offset = struct.calcsize("B")
        self.reg = np.array(struct.unpack_from("%dB" % self.m, mv, offset), dtype=np.int8)


def _pad_ids(docs, max_id: int):
    """Integer-id docs padded to (uint[B, T], int32[B]), T the longest doc
    (at least 1), in the narrowest unsigned dtype that holds ``max_id``
    (the device zero-extends it)."""
    lengths = np.fromiter(map(len, docs), np.int32, count=len(docs))
    dtype = (
        np.uint8 if max_id < (1 << 8)
        else np.uint16 if max_id < (1 << 16)
        else np.uint32
    )
    ids = np.zeros((len(docs), max(1, int(lengths.max()))), dtype=dtype)
    for i, d in enumerate(docs):
        ids[i, : len(d)] = d.astype(dtype)
    return ids, lengths


def _np_bit_length(x: np.ndarray) -> np.ndarray:
    """Vectorized ``int.bit_length()`` of nonnegative integer arrays.

    Values below 2**53 take the frexp path (float64 holds them exactly and
    the binary exponent is the bit length); wider values (possible only at
    p < 11 over 64-bit hashes) keep the exact shift ladder."""
    x = np.asarray(x).astype(np.uint64)
    if x.size and int(x.max()) < (1 << 53):
        return np.frexp(x.astype(np.float64))[1].astype(np.int64)
    n = np.zeros(x.shape, dtype=np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        y = x >> np.uint64(shift)
        big = y > 0
        n[big] += shift
        x = np.where(big, y, x)
    return n + (x > 0)


class HyperLogLogPlusPlus(HyperLogLog):
    """HyperLogLog++: 64-bit hashes, empirical bias correction and
    threshold-gated linear counting.

    With ``sparse=True`` the sketch stores ``(idx25, rank)`` pairs in a
    dict while small (HLL++ paper §5.3), counting by linear counting at
    2**25 precision, and densifies once the pairs outgrow the dense
    registers. Ranks are at dense precision, so the conversion is
    lossless; ``merge`` / ``serialize`` / pickling densify first, so the
    bytes stay the reference's.
    """

    _hash_range_bit = 64
    _hash_range_byte = 8
    _P_SPARSE = 25

    def __init__(
        self,
        p: int = 8,
        reg: Optional[np.ndarray] = None,
        hashfunc: Callable = sha1_hash64,
        hashobj: Optional[object] = None,
        sparse: bool = False,
        device_mode: str = "auto",
        device="cuda",
    ):
        super().__init__(
            p=p, reg=reg, hashfunc=hashfunc, hashobj=hashobj, device_mode=device_mode,
            device=device,
        )
        self._sparse = sparse and reg is None
        # idx25 -> max dense rank; densify when it outgrows the register
        # array's footprint (a dict entry ~= 8x an int8 register)
        self._sparse_items: Optional[dict] = {} if self._sparse else None
        self._sparse_max = max(16, self.m // 8)

    # ------------------------------------------------------------ sparse core

    def _sparse_add(self, idx25, ranks):
        items = self._sparse_items
        for i25, r in zip(idx25.tolist(), ranks.tolist()):
            prev = items.get(i25)
            if prev is None or r > prev:
                items[i25] = r
        if len(items) > self._sparse_max:
            self._to_dense()

    def _to_dense(self) -> None:
        """Lossless sparse -> dense conversion (ranks already dense)."""
        if not self._sparse:
            return
        items = self._sparse_items
        self._sparse = False
        self._sparse_items = None
        if items:
            idx25 = np.fromiter(items.keys(), dtype=np.int64, count=len(items))
            ranks = np.fromiter(items.values(), dtype=np.int8, count=len(items))
            np.maximum.at(self.reg, idx25 & (self.m - 1), ranks)

    @property
    def is_sparse(self) -> bool:
        return self._sparse

    def _get_threshold(self, p):
        return _bias_tables()[0][p - 4]

    def _estimate_bias(self, e, p):
        _, raw_estimate, bias = _bias_tables()
        estimate_vector = raw_estimate[p]
        nearest_neighbors = np.argsort((e - estimate_vector) ** 2)[:6]
        return np.mean(bias[p][nearest_neighbors])

    def update(self, b) -> None:
        if not self._sparse:
            super().update(b)
            return
        hv = self.hashfunc(b)
        rank = self._get_rank(hv >> self.p)
        i25 = int(hv & ((1 << self._P_SPARSE) - 1))
        prev = self._sparse_items.get(i25)
        if prev is None or rank > prev:
            self._sparse_items[i25] = rank
        if len(self._sparse_items) > self._sparse_max:
            self._to_dense()

    def update_batch(self, bs) -> None:
        """Vectorized update over 64-bit hashes."""
        if self.hashfunc is sha1_hash64:
            hv = batch_sha1_hash64(list(bs))
        elif self.hashfunc is device_hash64:
            ids = np.asarray(list(bs)).astype(np.uint64)
            if (
                not self._sparse
                and ids.size
                and int(ids.max()) < (1 << 32)
                and _use_device(self.device_mode, ids.size, self._DEVICE_BATCH_THRESHOLD)
            ):
                # raw 4-byte ids up, the mix64 limb rounds on the device
                dev = resolve_device(self.device)
                row = hll_ops.sketch_batch64_ids(
                    upload_bits(ids.astype(np.uint32)[None, :], dev),
                    torch.tensor([ids.size], dtype=torch.int32, device=dev), self.p,
                )
                np.maximum(self.reg, row.cpu().numpy()[0], out=self.reg)
                return
            hv = mix64_np(ids)
        else:
            hv = np.array([self.hashfunc(b) for b in bs], dtype=np.uint64)
        if hv.size == 0:
            return
        # A batch whose distinct sparse keys overflow the sparse budget
        # densifies mid-batch anyway; converting first gives the same
        # registers (max-merge commutes) and takes the vectorized paths.
        # Keys already stored are counted once, so re-ingesting the same
        # documents keeps a sketch sparse that the per-item path would.
        if self._sparse and hv.size + len(self._sparse_items) > self._sparse_max:
            idx25_probe = np.unique(
                (hv & np.uint64((1 << self._P_SPARSE) - 1)).astype(np.int64)
            )
            if self._sparse_items:
                existing = np.fromiter(
                    self._sparse_items.keys(), dtype=np.int64, count=len(self._sparse_items)
                )
                merged_distinct = np.union1d(idx25_probe, existing).size
            else:
                merged_distinct = idx25_probe.size
            if merged_distinct > self._sparse_max:
                self._to_dense()
        if not self._sparse and _use_device(
            self.device_mode, hv.size, self._DEVICE_BATCH_THRESHOLD
        ):
            row = self._device_sketch_rows(hv[None, :], np.array([hv.size], dtype=np.int32))
            np.maximum(self.reg, row.cpu().numpy()[0], out=self.reg)
            return
        if (
            not self._sparse
            and self.reg.dtype == np.int8
            and self.reg.flags.c_contiguous
            and self.reg.flags.writeable
        ):
            # at a 64-bit hash range every rank is >= 1: no overflow state
            native.hll_scatter(
                self.reg, np.ascontiguousarray(hv, dtype=np.uint64),
                np.array([hv.size], dtype=np.int64), self.p, self.max_rank,
            )
            return
        idx = (hv & np.uint64(self.m - 1)).astype(np.int64)
        bits = (hv >> np.uint64(self.p)).astype(np.uint64)
        ranks = self.max_rank - _np_bit_length(bits) + 1
        if np.any(ranks <= 0):
            raise ValueError(
                "Hash value overflow, maximum size is %d bits" % self.max_rank
            )
        if self._sparse:
            idx25 = (hv & np.uint64((1 << self._P_SPARSE) - 1)).astype(np.int64)
            self._sparse_add(idx25, ranks.astype(np.int8))
            return
        np.maximum.at(self.reg, idx, ranks.astype(np.int8))

    def _dense_reg(self) -> np.ndarray:
        """Dense registers without changing the sparse state."""
        if not self._sparse:
            return self.reg
        reg = self.reg.copy()
        items = self._sparse_items
        if items:
            idx25 = np.fromiter(items.keys(), dtype=np.int64, count=len(items))
            ranks = np.fromiter(items.values(), dtype=np.int8, count=len(items))
            np.maximum.at(reg, idx25 & (self.m - 1), ranks)
        return reg

    def count(self) -> float:
        """Bias-corrected estimate; in sparse mode, linear counting at
        2**25 precision."""
        if self._sparse:
            m25 = float(1 << self._P_SPARSE)
            v = len(self._sparse_items)
            if v == 0:
                return 0.0
            return m25 * np.log(m25 / (m25 - v))
        num_zero = self.m - np.count_nonzero(self.reg)
        if num_zero > 0:
            lc = self._linearcounting(num_zero)
            if lc <= self._get_threshold(self.p):
                return lc
        e = self.alpha * float(self.m**2) / np.sum(2.0 ** (-self.reg))
        if e <= 5 * self.m:
            return e - self._estimate_bias(e, self.p)
        return e

    def merge(self, other: "HyperLogLog") -> None:
        if self._sparse and isinstance(other, HyperLogLogPlusPlus) and other._sparse:
            if self.m != other.m or self.p != other.p:
                raise ValueError("Cannot merge HyperLogLog with different precisions.")
            for i25, r in other._sparse_items.items():
                prev = self._sparse_items.get(i25)
                if prev is None or r > prev:
                    self._sparse_items[i25] = r
            if len(self._sparse_items) > self._sparse_max:
                self._to_dense()
            return
        self._to_dense()
        if isinstance(other, HyperLogLogPlusPlus) and other._sparse:
            if self.m != other.m or self.p != other.p:
                raise ValueError("Cannot merge HyperLogLog with different precisions.")
            np.maximum(self.reg, other._dense_reg(), out=self.reg)
            return
        super().merge(other)

    def digest(self) -> np.ndarray:
        return self._dense_reg().copy()

    def is_empty(self) -> bool:
        if self._sparse:
            return len(self._sparse_items) == 0
        return super().is_empty()

    def clear(self) -> None:
        super().clear()
        if self._sparse_items is not None:
            self._sparse_items = {}
            self._sparse = True

    def copy(self) -> "HyperLogLogPlusPlus":
        new = HyperLogLogPlusPlus(
            p=self.p, hashfunc=self.hashfunc, sparse=self._sparse,
            device_mode=self.device_mode, device=self.device,
        )
        new.reg = self.reg.copy()
        if self._sparse:
            new._sparse_items = dict(self._sparse_items)
        return new

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.p == other.p
            and self.m == other.m
            and np.array_equal(self._dense_reg(), other._dense_reg())
        )

    def serialize(self, buf) -> None:
        self._to_dense()
        super().serialize(buf)

    def __getstate__(self):
        self._to_dense()
        return super().__getstate__()

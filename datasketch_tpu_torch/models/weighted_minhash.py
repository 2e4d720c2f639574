"""Weighted MinHash via Ioffe's consistent weighted sampling (CWS).

Port of ``datasketch_tpu/models/weighted_minhash.py``. The parameter draws
repeat the JAX package's ``np.random.RandomState`` sequence (rs ~ Gamma(2,
1), ln_cs = ln Gamma(2, 1), betas ~ U(0, 1), all float32), so the tables
are bit-equal at equal (dim, sample_size, seed). :meth:`minhash` runs on
the host in numpy, as the JAX package's does; :meth:`minhash_many` sketches
dense rows with kernel 6 and CSR rows with kernel 7 on the generator's
device, with the ``ln_y = (t - beta) * r`` formula of :meth:`minhash` on
every path (the JAX package's canonical choice), so batch and single
sketches agree.
"""

from __future__ import annotations

import collections.abc
import copy

import numpy as np
import torch

from datasketch_tpu_torch.device import resolve_device
from datasketch_tpu_torch.kernels import cws

__all__ = ["WeightedMinHash", "WeightedMinHashGenerator"]


class WeightedMinHash:
    """A weighted-Jaccard sketch: ``sample_size`` rows of (k, t) pairs.

    Create via :class:`WeightedMinHashGenerator`, or from (seed, hashvalues).
    """

    def __init__(self, seed: int, hashvalues: np.ndarray) -> None:
        self.seed = seed
        self.hashvalues = hashvalues

    def jaccard(self, other: "WeightedMinHash") -> float:
        """Estimated weighted Jaccard: fraction of equal (k, t) rows."""
        if other.seed != self.seed:
            raise ValueError(
                "Cannot compute Jaccard given WeightedMinHash objects with "
                "different seeds"
            )
        if len(self) != len(other):
            raise ValueError(
                "Cannot compute Jaccard given WeightedMinHash objects with "
                "different numbers of hash values"
            )
        intersection = int(
            np.count_nonzero(np.all(self.hashvalues == other.hashvalues, axis=1))
        )
        return float(intersection) / float(len(self))

    def digest(self) -> np.ndarray:
        return copy.copy(self.hashvalues)

    def copy(self) -> "WeightedMinHash":
        return WeightedMinHash(self.seed, self.digest())

    def __len__(self) -> int:
        return len(self.hashvalues)

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.seed == other.seed
            and np.array_equal(self.hashvalues, other.hashvalues)
        )


class WeightedMinHashGenerator:
    """Factory holding the CWS random parameters for a (dim, sample_size).

    Args:
        dim: dimensionality of the weight vectors.
        sample_size: number of (k, t) samples per sketch.
        seed: seed of the parameter draws.
        device: where :meth:`minhash_many` runs: ``"cuda"`` (default;
            kernels 6 and 7) or ``"cpu"`` (their plain PyTorch versions).
            ``"cuda"`` without a usable card raises.
    """

    # dense elements uploaded per kernel-6 launch
    _CHUNK_ELEMS = 1 << 26

    def __init__(self, dim: int, sample_size: int = 128, seed: int = 1,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.dim = dim
        self.sample_size = sample_size
        self.seed = seed
        generator = np.random.RandomState(seed=seed)
        self.rs = generator.gamma(2, 1, (sample_size, dim)).astype(np.float32)
        self.ln_cs = np.log(generator.gamma(2, 1, (sample_size, dim))).astype(
            np.float32
        )
        self.betas = generator.uniform(0, 1, (sample_size, dim)).astype(np.float32)
        self._params_t = None  # f32[D, S] tables on the device, made once

    def __getstate__(self) -> dict:
        """Pickle the parameters, not the device tables cached from them:
        those are remade on the first use after unpickling, where a CUDA
        tensor in the pickle would need a card to load."""
        state = self.__dict__.copy()
        state["_params_t"] = None
        return state

    def minhash(self, v) -> WeightedMinHash:
        """Sketch one weight vector on the host (k = argmin of ln a over
        the non-zero dims)."""
        if not isinstance(v, collections.abc.Sized):
            raise TypeError("Input vector must be sized")
        if not len(v) == self.dim:
            raise ValueError("Input dimension mismatch, expecting %d" % self.dim)
        v = np.array(v, dtype=np.float32)
        vzeros = v == 0
        if vzeros.all():
            raise ValueError("Input is all zeros")
        v[vzeros] = np.nan
        vlog = np.log(v)
        t = np.floor((vlog / self.rs) + self.betas)
        ln_y = (t - self.betas) * self.rs
        ln_a = self.ln_cs - ln_y - self.rs
        k = np.nanargmin(ln_a, axis=1)
        hashvalues = np.zeros((self.sample_size, 2), dtype=int)
        hashvalues[:, 0] = k
        hashvalues[:, 1] = t[np.arange(self.sample_size), k].astype(int)
        return WeightedMinHash(self.seed, hashvalues)

    def params_t(self):
        """The transposed f32[D, S] tables (rs, ln_cs, betas) on the
        generator's device, uploaded on the first call and kept."""
        if self._params_t is None:
            self._params_t = tuple(
                torch.from_numpy(np.ascontiguousarray(p.T)).to(self.device)
                for p in (self.rs, self.ln_cs, self.betas)
            )
        return self._params_t

    def minhash_many(self, X, out: str = "objects"):
        """Sketch each row of a dense numpy or scipy sparse weight matrix.

        Entries <= 0 are inactive. CSR rows go to kernel 7 as they are
        (after sorting their indices, for the lowest-dim tie rule); dense
        rows go to kernel 6 in chunks of ``_CHUNK_ELEMS`` elements.

        Args:
            out: ``'objects'`` (default): a list of :class:`WeightedMinHash`,
                ``None`` for a row that is entirely zero (sparse: one with
                no positive entry). ``'device'``: one int32[N, sample_size, 2]
                tensor of (k, t) pairs on the generator's device, which the
                indexes take as they are; such a zero row raises
                ``ValueError`` naming it.
        """
        import scipy.sparse as sp

        if out not in ("objects", "device"):
            raise ValueError("out must be 'objects' or 'device'")
        if not isinstance(X, (sp.spmatrix, np.ndarray)) and not sp.issparse(X):
            raise TypeError("Input X must be a sparse matrix or numpy matrix")
        if X.ndim != 2:
            raise ValueError("Input must have two dimensions")
        if X.shape[1] != self.dim:
            raise ValueError("Input dimension mismatch, expecting %d" % self.dim)
        if sp.issparse(X):
            kt, nonzero = self._sparse(X.tocsr())
        else:
            kt, nonzero = self._dense(X)
        if out == "device":
            if not nonzero.all():
                raise ValueError(
                    "row %d is all zeros; out='device' has no None slot -- "
                    "filter zero rows first" % int(np.nonzero(~nonzero)[0][0])
                )
            return kt
        host = kt.cpu().numpy()
        return [WeightedMinHash(self.seed, host[i].astype(int)) if nonzero[i] else None
                for i in range(host.shape[0])]

    def _dense(self, X: np.ndarray):
        """(kt on the device, host bool[N]: the row has a non-zero entry)."""
        n = X.shape[0]
        chunk = max(1, self._CHUNK_ELEMS // max(1, self.dim))
        parts, nonzero = [], []
        for start in range(0, n, chunk):
            w = torch.from_numpy(
                np.ascontiguousarray(X[start: start + chunk], dtype=np.float32)
            ).to(self.device)
            nonzero.append((w != 0).any(dim=1))
            parts.append(cws.cws_dense(w, *self.params_t()))
        if not parts:
            empty = torch.zeros((0, self.sample_size, 2), dtype=torch.int32,
                                device=self.device)
            return empty, np.zeros(0, dtype=bool)
        kt = parts[0] if len(parts) == 1 else torch.cat(parts)
        return kt, torch.cat(nonzero).cpu().numpy()

    def _sparse(self, X):
        """(kt on the device, host bool[N]: the row has a positive entry).
        The CSR arrays are uploaded whole and sketched in one launch."""
        if not X.has_sorted_indices:
            X = X.sorted_indices()
        dev = self.device
        vals = torch.from_numpy(np.asarray(X.data, dtype=np.float32)).to(dev)
        idx = torch.from_numpy(np.asarray(X.indices, dtype=np.int32)).to(dev)
        indptr = torch.from_numpy(np.asarray(X.indptr, dtype=np.int64)).to(dev)
        positive = torch.zeros(vals.shape[0] + 1, dtype=torch.int64, device=dev)
        positive[1:] = torch.cumsum(vals > 0, 0)
        counts = positive[indptr[1:]] - positive[indptr[:-1]]
        kt = cws.cws_sparse(vals, idx, indptr, *self.params_t())
        return kt, (counts > 0).cpu().numpy()

"""Hand-written Hopper kernels (CUDA C++ in ``datasketch_tpu_torch/csrc``).

One module per kernel, each with its plain PyTorch twin and a ``launches``
counter that the wrapper bumps where it launches the kernel and nowhere
else. Each wrapper's body is the ``dstt.kernel.<module>`` span while a
profiler records (:mod:`datasketch_tpu_torch.utils.profiling`):

- :mod:`~datasketch_tpu_torch.kernels.minhash_sign` -- kernel 1, signatures
- :mod:`~datasketch_tpu_torch.kernels.lsh_scan` -- kernel 2, fused top-k scan
- :mod:`~datasketch_tpu_torch.kernels.rerank` -- kernel 3, fused-gather rerank
- :mod:`~datasketch_tpu_torch.kernels.score` -- kernel 4, score matrix
- :mod:`~datasketch_tpu_torch.kernels.bbit` -- kernel 5, packed b-bit counts
- :mod:`~datasketch_tpu_torch.kernels.cws` -- kernels 6 and 7, CWS (k, t)
- :mod:`~datasketch_tpu_torch.kernels.compact` -- kernel 8, ragged compaction
  of a padded threshold result
- :mod:`~datasketch_tpu_torch.kernels.sha1` -- kernel 9, ``sha1_hash32`` of
  bytes tokens read in place from pinned host memory

Nothing is built at import: :func:`datasketch_tpu_torch.kernels.build.library`
compiles the sources with ``nvcc`` at the first launch.
"""

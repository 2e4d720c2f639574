"""Hand-written Hopper kernels (CUDA C++ in ``datasketch_tpu_torch/csrc``).

One module per kernel, each with its plain PyTorch twin and a ``launches``
counter that the wrapper bumps where it launches the kernel and nowhere
else:

- :mod:`~datasketch_tpu_torch.kernels.minhash_sign` -- kernel 1, signatures
- :mod:`~datasketch_tpu_torch.kernels.lsh_scan` -- kernel 2, fused top-k scan
- :mod:`~datasketch_tpu_torch.kernels.rerank` -- kernel 3, fused-gather rerank
- :mod:`~datasketch_tpu_torch.kernels.score` -- kernel 4, score matrix
- :mod:`~datasketch_tpu_torch.kernels.bbit` -- kernel 5, packed b-bit counts
- :mod:`~datasketch_tpu_torch.kernels.cws` -- kernels 6 and 7, CWS (k, t)

Nothing is built at import: :func:`datasketch_tpu_torch.kernels.build.library`
compiles the sources with ``nvcc`` at the first launch.
"""

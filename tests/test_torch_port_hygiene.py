"""Port hygiene: importing the port pulls in neither JAX nor the JAX package
and creates no CUDA context; device choice is explicit; kernel wrappers
take their plain version only for CPU tensors."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import (
    HNSW,
    HyperLogLog,
    HyperLogLogPlusPlus,
    MinHash,
    TorchBBitIndex,
    TorchHNSW,
    TorchMinHashLSH,
    TorchMinHashLSHEnsemble,
    TorchMinHashLSHBloom,
    TorchMinHashLSHForest,
    WeightedMinHashGenerator,
)
from datasketch_tpu_torch.device import resolve_device
from datasketch_tpu_torch.utils import device_healthcheck
from datasketch_tpu_torch.ops import knn_graph
from datasketch_tpu_torch.kernels import bbit, cws, lsh_scan, minhash_sign, rerank, score

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_and_no_cuda_context():
    code = "\n".join([
        "import sys, torch",
        "import datasketch_tpu_torch",
        "from datasketch_tpu_torch import native, hashfunc, device, persist",
        "from datasketch_tpu_torch.ops import hashing, minhash_ops, lsh_ops, cws_ops",
        "from datasketch_tpu_torch.ops import bbit_ops, text_ops, forest_ops",
        "from datasketch_tpu_torch.ops import hll_ops, oph, cminhash, hnsw_ops, knn_graph",
        "from datasketch_tpu_torch.models import hyperloglog, lsh_bloom",
        "from datasketch_tpu_torch import hyperloglog_const",
        "from datasketch_tpu_torch.models import minhash, lsh_params, torch_lsh",
        "from datasketch_tpu_torch.models import lean_minhash, lshforest, torch_forest",
        "from datasketch_tpu_torch.models import lshensemble, torch_ensemble",
        "from datasketch_tpu_torch.models import weighted_minhash, b_bit_minhash, torch_bbit",
        "from datasketch_tpu_torch.models import hnsw, torch_hnsw",
        "from datasketch_tpu_torch.kernels import build, cws, lsh_scan, minhash_sign, rerank",
        "from datasketch_tpu_torch.kernels import bbit, score",
        "from datasketch_tpu_torch.utils import pipeline, profiling, health",
        "from datasketch_tpu_torch import storage, serving, aio, experimental",
        "from datasketch_tpu_torch.aio import lsh as aio_lsh, storage as aio_storage",
        "from datasketch_tpu_torch.experimental.aio import lsh as experimental_lsh",
        "from datasketch_tpu_torch.models import lsh",
        "from datasketch_tpu_torch import minhash, lean_minhash, weighted_minhash",
        "from datasketch_tpu_torch import hyperloglog, b_bit_minhash, lshforest",
        "from datasketch_tpu_torch import lshensemble, lshensemble_partition, lsh_bloom",
        "from datasketch_tpu_torch import hnsw, torch_lsh, torch_ensemble",
        "from datasketch_tpu_torch import parallel",
        "from datasketch_tpu_torch.parallel import mesh, collectives, sharded_sketch",
        "from datasketch_tpu_torch.parallel import sharded_lsh, sharded_bbit, sharded_bloom",
        "from datasketch_tpu_torch.parallel import sharded_ensemble, sharded_forest",
        "from datasketch_tpu_torch.parallel import sharded_hnsw",
        "import torch.distributed as dist",
        "assert not dist.is_initialized()",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'datasketch_tpu'))",
        "assert not bad, bad",
        "clients = sorted(m for m in sys.modules if m.split('.')[0] in",
        "                 ('redis', 'motor', 'cassandra', 'pymongo'))",
        "assert not clients, clients",
        "assert not torch.cuda.is_initialized()",
        "print('clean')",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchMinHashLSH(threshold=0.5, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinHash.bulk_signatures([[b"a", b"b"]], device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchMinHashLSHEnsemble(threshold=0.8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WeightedMinHashGenerator(100, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBBitIndex(b=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinHash.bulk_from_text([b"abcdefghijk"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchMinHashLSHForest()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinHash(device_mode="always").update_batch([b"a", b"b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinHash.bulk_signatures([[b"a", b"b"]], scheme="oph", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MinHash.bulk_signatures([[b"a", b"b"]], scheme="cminhash", device_mode="always",
                                device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HyperLogLog(device_mode="always").update_batch([b"a", b"b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HyperLogLogPlusPlus(hashfunc="device", device_mode="always").update_batch([1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HyperLogLogPlusPlus.bulk_registers([[b"a"]], device_mode="always")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HyperLogLogPlusPlus.bulk_registers([[1, 2]], hashfunc="device", device_mode="always")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchMinHashLSHBloom()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchHNSW()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn_graph.build_nsw_graph(np.zeros((3, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        knn_graph.knn_adjacency(np.zeros((3, 4), np.float32), k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HNSW.from_points(np.zeros((3, 4), np.float32))
    from datasketch_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4, device="cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_default_healthcheck_reports_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    res = device_healthcheck()
    assert res["ok"] is False and res["latency_s"] is None
    assert "no CUDA device" in res["error"]
    assert not torch.cuda.is_initialized()


def test_pre_hopper_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        resolve_device("cuda")


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["minhash_sign", "topk_scan", "containment_topk",
                                  "rerank", "score", "bbit", "cws_dense", "cws_sparse"])
def test_wrapper_on_other_device_raises(name):
    """A tensor that is neither on the CPU nor on a card never takes the
    plain version (which would happily run on 'meta')."""
    calls = {
        "minhash_sign": lambda: minhash_sign.minhash_sign(
            _meta((10,)), _meta((2,), torch.int64), _meta((2,)),
            _meta((128,), torch.int64), _meta((128,), torch.int64)),
        "topk_scan": lambda: lsh_scan.topk_scan(_meta((64, 128)), _meta((3, 128)), 5, 64),
        "containment_topk": lambda: lsh_scan.containment_topk(
            _meta((64, 128)), _meta((64,)), _meta((3, 128)), _meta((3,)), 5, 0.8),
        "rerank": lambda: rerank.rerank_scores(_meta((64, 128)), _meta((3, 128)),
                                               _meta((3, 7))),
        "score": lambda: score.score_matrix(_meta((3, 128)), _meta((64, 128))),
        "bbit": lambda: bbit.bbit_counts(_meta((3, 4)), _meta((64, 4)), 1),
        "cws_dense": lambda: cws.cws_dense(_meta((3, 50), torch.float32),
                                           *[_meta((50, 128), torch.float32)] * 3),
        "cws_sparse": lambda: cws.cws_sparse(
            _meta((9,), torch.float32), _meta((9,)), _meta((4,), torch.int64),
            *[_meta((50, 128), torch.float32)] * 3),
    }

    def counters():
        return (minhash_sign.launches, lsh_scan.launches, lsh_scan.launches_sizes,
                rerank.launches, score.launches, bbit.launches, cws.launches,
                cws.launches_sparse)

    before = counters()
    with pytest.raises(ValueError, match="CUDA device"):
        calls[name]()
    assert counters() == before

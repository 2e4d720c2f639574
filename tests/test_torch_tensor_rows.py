"""Lists of tensor rows (for example rows of a ``bulk_signatures(out=
"device")`` batch) are stacked on their own device and take the batch
path: nothing converts a device row to numpy. On the CPU every answer
equals the batch call's; the card's own check is in
``tests/test_torch_cuda_kernels.py``."""

import numpy as np
import pytest
import torch

from datasketch_tpu_torch import TorchBBitIndex, TorchMinHashLSH, TorchMinHashLSHEnsemble
from datasketch_tpu_torch.models.torch_lsh import _as_signature_matrix

torch.set_num_threads(2)


def _sigs(n=400, p=128, seed=0):
    rng = np.random.RandomState(seed)
    sigs = rng.randint(0, 1 << 32, size=(n, p), dtype=np.uint64).astype(np.uint32)
    sigs[n // 2:] = np.where(rng.rand(n - n // 2, p) < 0.8, sigs[: n - n // 2], sigs[n // 2:])
    return torch.from_numpy(sigs.view(np.int32))


@pytest.mark.parametrize("shape", [(5, 128), (5, 64, 2)])
def test_tensor_rows_stack_where_they_lie(shape):
    """Rows on a device without numpy (``meta``) stack there: a fetch would
    raise."""
    rows = list(torch.zeros(shape, dtype=torch.int32, device="meta"))
    out = _as_signature_matrix(rows, torch.device("meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (5, shape[1])


def test_lsh_lists_of_tensor_rows_answer_as_the_batch():
    sigs = _sigs()
    batch = TorchMinHashLSH(threshold=0.5, device="cpu")
    rows = TorchMinHashLSH(threshold=0.5, device="cpu")
    batch.index(range(400), sigs)
    rows.index(range(200), list(sigs[:200]))
    for i in range(200, 400):
        rows.insert(i, sigs[i])
    queries = sigs[190:230]
    for method in ("scan", "bands"):
        want = batch.top_k(queries, 5, method=method)
        assert rows.top_k(list(queries), 5, method=method) == want
        assert batch.top_k(list(queries), 5, method=method) == want
        assert batch.query_batch(list(queries), method=method) == \
            batch.query_batch(queries, method=method)
    assert rows.query(sigs[250]) == batch.query(sigs[250].numpy().view(np.uint32))


def test_bbit_lists_of_tensor_rows_answer_as_the_batch():
    sigs = _sigs(seed=1)
    batch = TorchBBitIndex(b=2, num_perm=128, device="cpu")
    rows = TorchBBitIndex(b=2, num_perm=128, device="cpu")
    batch.insert_batch(range(400), sigs)
    rows.insert_batch(range(399), list(sigs[:399]))
    rows.insert(399, sigs[399])
    queries = sigs[180:220]
    want = batch.query_batch(queries, 7, return_scores=True)
    assert rows.query_batch(list(queries), 7, return_scores=True) == want
    assert rows.query(sigs[300], 3) == batch.query_batch(sigs[300:301], 3)[0]


def test_ensemble_tensor_rows_answer_as_the_batch():
    sigs = _sigs(seed=2)
    sizes = np.random.RandomState(3).randint(10, 500, 400)
    batch = TorchMinHashLSHEnsemble(threshold=0.8, num_part=4, device="cpu")
    rows = TorchMinHashLSHEnsemble(threshold=0.8, num_part=4, device="cpu")
    batch.index_batch(range(400), sigs, sizes)
    rows.index([(i, sigs[i], int(sizes[i])) for i in range(400)])
    q_sizes = [int(s) for s in sizes[150:190]]
    for method in ("scan", "bands"):
        want = batch.query_batch((sigs[150:190], q_sizes), method=method)
        got = rows.query_batch(list(zip(sigs[150:190], q_sizes)), method=method)
        if method == "bands":
            want, got = [set(r) for r in want], [set(r) for r in got]
        assert got == want
    assert rows.query_batch((sigs[160], q_sizes[10]), method="scan") == \
        batch.query_batch((sigs[160:161], q_sizes[10:11]), method="scan")


def test_kt_tensor_rows_mix_as_the_batch():
    """(k, t) rows with negative t, one by one or in a list, mix to the
    slots of the [N, P, 2] batch."""
    rng = np.random.RandomState(4)
    kt = np.stack([rng.randint(0, 1000, (60, 64)), rng.randint(-50, 50, (60, 64))],
                  axis=-1).astype(np.int32)
    batch = TorchMinHashLSH(threshold=0.5, num_perm=64, device="cpu")
    rows = TorchMinHashLSH(threshold=0.5, num_perm=64, device="cpu")
    batch.index(range(60), torch.from_numpy(kt))
    rows.index(range(30), list(torch.from_numpy(kt[:30])))
    for i in range(30, 60):
        rows.insert(i, torch.from_numpy(kt[i]))
    assert rows.status()["n_live"] == 60  # flushes the inserts
    assert torch.equal(rows._sigs, batch._sigs)

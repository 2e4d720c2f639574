"""Two processes in one gloo group: the port's mesh across processes.

Mirrors ``tests/test_multihost.py`` and ``tests/multihost_worker.py``: two
real processes (this file, run as a script, is the worker) join one
``torch.distributed`` gloo group over a localhost port, each owning 2 of a
global 4-position CPU mesh, and

1. run the collectives across the mesh (all_gather, psum, pmin, pmax,
   sharded signatures and the two unions);
2. build and query a ``ShardedMinHashLSH`` (and the other sharded indexes)
   whose documents span both processes, with answers equal to the same
   index on a 4-position mesh inside one process;
3. hand an index off: every rank saves (a collective), a barrier, rank 1
   loads rank 0's file onto a local 3-position mesh and answers equal; then
   ``merge`` and ``compact`` across the processes.

Usage as a worker: python test_torch_multiprocess.py <port> <rank> <world> <tmpdir>
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_and_index_handoff(tmp_path):
    # bound: one communicate(timeout=240) per worker (no pytest-timeout here)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(rank), "2",
                          str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError("workers timed out:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "worker %d failed:\n%s" % (rank, out)
        for line in ("collectives OK", "global-mesh index OK", "handoff OK", "indexes OK"):
            assert "[%d] %s" % (rank, line) in out, out


def _corpus(np, n=200, p=64, seed=0):
    rng = np.random.RandomState(seed)  # the same corpus in every process
    sigs = rng.randint(0, 1 << 32, size=(n, p), dtype=np.uint64).astype(np.uint32)
    sigs[n // 2:] = np.where(rng.rand(n - n // 2, p) < 0.7, sigs[: n - n // 2], sigs[n // 2:])
    return sigs


def worker(port: str, rank: int, world: int, tmpdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from datasketch_tpu_torch.parallel import (
        ShardedBBitIndex,
        ShardedHNSW,
        ShardedMinHashLSH,
        ShardedMinHashLSHBloom,
        ShardedMinHashLSHEnsemble,
        ShardedMinHashLSHForest,
        distributed_hll_union,
        distributed_minhash_union,
        init_distributed,
        make_mesh,
        sharded_compute_signatures,
    )
    from datasketch_tpu_torch.parallel import collectives
    from datasketch_tpu_torch.parallel.mesh import Mesh

    init_distributed("localhost:%s" % port, num_processes=world, process_id=rank,
                     backend="gloo")
    mesh = make_mesh(4, axis_names=("data",), device="cpu")
    assert mesh.world == world and mesh.local_shards("data") == [2 * rank, 2 * rank + 1]
    local4 = Mesh([torch.device("cpu")] * 4, ("data",))

    # 1. collectives across the processes
    mine = {s: torch.full((2, 3), s + 1, dtype=torch.int32) for s in mesh.local_shards("data")}
    g = collectives.all_gather_cat(mesh, "data", mine, dim=1)
    assert g[0].tolist() == [1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4], g
    assert int(collectives.psum(mesh, {s: s + 1 for s in mine})) == 10
    assert int(collectives.pmin(mesh, {s: torch.tensor(s + 5) for s in mine})) == 5
    assert int(collectives.pmax(mesh, {s: torch.tensor(s + 5) for s in mine})) == 8
    rng = np.random.RandomState(1)
    hashes = rng.randint(0, 1 << 32, size=(16, 40), dtype=np.uint64).astype(np.uint32)
    lengths = rng.randint(1, 41, size=16).astype(np.int32)
    sh = sharded_compute_signatures(hashes, lengths, seed=1, num_perm=32, mesh=mesh)
    want = np.asarray(sharded_compute_signatures(hashes, lengths, seed=1, num_perm=32,
                                                 mesh=local4))
    assert np.array_equal(np.asarray(sh), want)
    union = distributed_minhash_union(sh, mesh).numpy().view(np.uint32)
    assert np.array_equal(union, want.min(axis=0))
    regs = torch.from_numpy(rng.randint(0, 30, size=(8, 64)).astype(np.int8))
    assert torch.equal(distributed_hll_union(regs, mesh), regs.max(dim=0).values)
    print("[%d] collectives OK" % rank, flush=True)

    # 2. a sharded index whose rows span both processes
    sigs = _corpus(np)
    keys = ["d%d" % i for i in range(sigs.shape[0])]
    q = sigs[:12]
    index = ShardedMinHashLSH(mesh, threshold=0.5, num_perm=64, bucket_cap=4)
    ref = ShardedMinHashLSH(local4, threshold=0.5, num_perm=64, bucket_cap=4)
    for ix in (index, ref):
        ix.index(keys[:150], sigs[:150])
        ix.index(keys[150:], sigs[150:])  # incremental: collected through the host
        ix.remove("d7")
    for method in ("bands", "scan"):
        assert index.top_k(q, 5, method=method) == ref.top_k(q, 5, method=method), method
        assert index.last_truncated == ref.last_truncated
        got = index.query_batch(q, method=method, return_scores=True)
        assert got == ref.query_batch(q, method=method, return_scores=True), method
        assert index.last_truncated == ref.last_truncated
    assert list(index.top_k_stream([q, q], 5, depth=2)) == [ref.top_k(q, 5)] * 2
    st, st_ref = index.status(), ref.status()
    assert {k: v for k, v in st.items() if k != "device_bytes"} == \
        {k: v for k, v in st_ref.items() if k != "device_bytes"}
    snap = index.host_snapshot()
    assert np.array_equal(snap["sigs"], sigs) and snap["alive"].sum() == 199
    print("[%d] global-mesh index OK" % rank, flush=True)

    # 3. save (a collective) -> barrier -> load onto a local 3-position mesh
    index.save(os.path.join(tmpdir, "handoff_%d.npz" % rank))
    dist.barrier()
    if rank == 1:
        loaded = ShardedMinHashLSH.load(os.path.join(tmpdir, "handoff_0.npz"),
                                        Mesh([torch.device("cpu")] * 3, ("data",)))
        assert len(loaded) == 199 and loaded.n_shards == 3
        for method in ("bands", "scan"):
            assert loaded.query_batch(q, method=method) == ref.query_batch(q, method=method)
    dist.barrier()
    # merge and compact collect the rows through the host (collectives)
    other = _corpus(np, n=60, seed=3)
    okeys = ["o%d" % i for i in range(60)]
    for ix, mesh_ in ((index, mesh), (ref, local4)):
        more = ShardedMinHashLSH(mesh_, threshold=0.5, num_perm=64, bucket_cap=4)
        more.index(okeys, other)
        more.remove("o5")
        ix.merge(more)
        ix.compact()
    q2 = np.concatenate([q, other[:6]])
    assert index.top_k(q2, 5, method="bands") == ref.top_k(q2, 5, method="bands")
    assert index.status()["n_live"] == ref.status()["n_live"] == 258
    print("[%d] handoff OK" % rank, flush=True)

    # 4. the other sharded indexes on the global mesh
    def pair(cls, *args, **kwargs):
        return cls(mesh, *args, **kwargs), cls(local4, *args, **kwargs)

    forest, f_ref = pair(ShardedMinHashLSHForest, num_perm=64, l=8, cap=8)
    bbit, b_ref = pair(ShardedBBitIndex, b=2, num_perm=64)
    ens, e_ref = pair(ShardedMinHashLSHEnsemble, threshold=0.5, num_perm=64, num_part=3,
                      bucket_cap=8)
    bloom, bl_ref = pair(ShardedMinHashLSHBloom, threshold=0.5, num_perm=64, n=1000)
    hnsw, h_ref = pair(ShardedHNSW, distance_metric="minhash_jaccard", m=4, ef=16)
    sizes = rng.randint(10, 200, size=sigs.shape[0])
    for ix in (forest, f_ref, hnsw, h_ref):
        ix.index(keys, sigs)
    for ix in (bbit, b_ref):
        ix.insert_batch(keys, sigs)
        ix.remove_batch(["d3"])
    for ix in (ens, e_ref):
        ix.index_batch(keys, sigs, sizes)
    for ix in (bloom, bl_ref):
        ix.insert_batch(sigs[:100])
    assert forest.query_batch(q, 4, return_scores=True) == f_ref.query_batch(q, 4,
                                                                             return_scores=True)
    assert bbit.query_batch(q, 4, return_scores=True) == b_ref.query_batch(q, 4,
                                                                           return_scores=True)
    qs = (q, sizes[:12])
    assert ens.query_batch(qs, method="scan") == e_ref.query_batch(qs, method="scan")
    assert [sorted(r) for r in ens.query_batch(qs, method="bands")] == \
        [sorted(r) for r in e_ref.query_batch(qs, method="bands")]
    assert np.array_equal(bloom.query_batch(sigs), bl_ref.query_batch(sigs))
    assert hnsw.query_batch(q, k=4) == h_ref.query_batch(q, k=4)
    dist.barrier()
    print("[%d] indexes OK" % rank, flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

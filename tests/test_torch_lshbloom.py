"""Port parity: TorchMinHashLSHBloom (device="cpu") against the JAX
package's TpuMinHashLSHBloom, and the host MinHashLSHBloom / BloomTable
against the JAX package's, after the same inserts: word bitmaps, answers
and ``.npz`` files (array by array, written by one package and loaded by
the other) must be equal."""

import warnings

import numpy as np
import pytest
import torch

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu.models.lsh_bloom import BloomTable as JaxBloomTable
from datasketch_tpu.models.lsh_bloom import MinHashLSHBloom as JaxBloom
from datasketch_tpu.models.lsh_bloom import TpuMinHashLSHBloom
from datasketch_tpu_torch import MinHash, MinHashLSHBloom, TorchMinHashLSHBloom
from datasketch_tpu_torch.models.lsh_bloom import BloomTable

torch.set_num_threads(2)


def _sigs(n, seed, p=128):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, size=(n, p), dtype=np.uint64).astype(np.uint32)


def _pair(**kw):
    return TorchMinHashLSHBloom(device="cpu", **kw), TpuMinHashLSHBloom(**kw)


def _words(ix):
    return ix._words.numpy().view(np.uint32) if isinstance(ix._words, torch.Tensor) \
        else np.asarray(ix._words)


@pytest.mark.parametrize("kw", [dict(threshold=0.8, n=5000, fp=0.01),
                                dict(threshold=0.5, n=300, fp=0.2),
                                dict(params=(4, 8), n=1000, fp=0.05, num_perm=64)])
def test_words_and_answers_match_jax(kw):
    p = kw.get("num_perm", 128)
    ours, ref = _pair(**kw)
    assert (ours.b, ours.r, ours.num_bits, ours.num_hashes, ours.num_words) == \
        (ref.b, ref.r, ref.num_bits, ref.num_hashes, ref.num_words)
    sigs = _sigs(700, 1, p)
    for batch in (sigs[:300], sigs[300:301], sigs[301:]):
        ours.insert_batch(batch)
        ref.insert_batch(list(batch))
        np.testing.assert_array_equal(_words(ours), _words(ref))
    probe = np.concatenate([sigs[::7], _sigs(400, 2, p)])
    got = ours.query_batch(probe)
    np.testing.assert_array_equal(got, ref.query_batch(list(probe)))
    assert got[: len(sigs[::7])].all()  # no false negative
    assert ours.query(sigs[5]) and ours.query_batch([]).shape == (0,)
    ours.insert_batch([])
    tensor_rows = torch.from_numpy(probe.view(np.int32))
    np.testing.assert_array_equal(ours.query_batch(tensor_rows), got)
    np.testing.assert_array_equal(ours.query_batch(list(tensor_rows)), got)
    mh = MinHash(num_perm=p, hashvalues=probe[-1].astype(np.uint64))
    assert ours.query(mh) == ref.query(JaxMinHash(num_perm=p, hashvalues=probe[-1]))


def test_insert_tokens_and_text_match_jax():
    rng = np.random.RandomState(3)
    docs = [rng.randint(0, 5000, size=rng.randint(1, 80)).astype(np.uint32) for _ in range(120)]
    texts = [bytes(rng.randint(97, 123, size=int(n), dtype=np.uint8))
             for n in rng.randint(0, 200, 60)]
    ours, ref = _pair(threshold=0.7, n=2000, fp=0.01)
    for ix in (ours, ref):
        ix.insert_tokens(docs, seed=3)
        ix.insert_text(texts, k=5, seed=3)
    np.testing.assert_array_equal(_words(ours), _words(ref))
    q = MinHash.bulk_signatures(docs[:10], num_perm=128, seed=3, hashfunc="device", device="cpu")
    assert ours.query_batch(q).all()


def test_npz_files_load_across_packages(tmp_path):
    ours, ref = _pair(threshold=0.8, n=3000, fp=0.01)
    sigs = _sigs(500, 4)
    ours.insert_batch(sigs)
    ref.insert_batch(list(sigs))
    ours.save(str(tmp_path / "ours"))
    ref.save(str(tmp_path / "ref.npz"))
    a, b = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        assert a[name].dtype == b[name].dtype
        np.testing.assert_array_equal(a[name], b[name])
    back = TorchMinHashLSHBloom.load(str(tmp_path / "ref"), device="cpu")
    np.testing.assert_array_equal(_words(back), _words(ref))
    assert (back.threshold, back.b, back.r, back.num_bits) == (0.8, ref.b, ref.r, ref.num_bits)
    np.testing.assert_array_equal(back.query_batch(sigs[:50]), np.ones(50, bool))
    jax_back = TpuMinHashLSHBloom.load(str(tmp_path / "ours"))
    np.testing.assert_array_equal(_words(jax_back), _words(ours))
    # the older bool layout, and a file of another probe scheme
    bits = np.unpackbits(_words(ours).view(np.uint8), bitorder="little").reshape(ours.b, -1)
    np.savez(tmp_path / "old.npz", bits=bits[:, : ours.num_bits].astype(bool),
             meta=np.array([128, ours.b, ours.r, ours.num_bits, ours.num_hashes]),
             probe_scheme=np.int64(2), threshold=np.float64(0.8))
    old = TorchMinHashLSHBloom.load(str(tmp_path / "old.npz"), device="cpu")
    np.testing.assert_array_equal(_words(old), _words(ours))
    np.savez(tmp_path / "v1.npz", bits_packed=_words(ours),
             meta=np.array([128, ours.b, ours.r, ours.num_bits, ours.num_hashes]),
             threshold=np.float64(0.8))
    with pytest.raises(ValueError, match="probe scheme v1"):
        TorchMinHashLSHBloom.load(str(tmp_path / "v1.npz"), device="cpu")


def test_host_classes_match_jax(tmp_path):
    sigs = _sigs(200, 5)
    objs = [MinHash(num_perm=128, hashvalues=r.astype(np.uint64)) for r in sigs]
    refs = [JaxMinHash(num_perm=128, hashvalues=r.astype(np.uint64)) for r in sigs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ours = MinHashLSHBloom(threshold=0.8, num_perm=128, n=1000, fp=0.01)
        ref = JaxBloom(threshold=0.8, num_perm=128, n=1000, fp=0.01)
    ours.insert_batch(objs[:150])
    ref.insert_batch(refs[:150])
    ours.insert(objs[150])
    ref.insert(refs[150])
    for t, rt in zip(ours.hashtables, ref.hashtables):
        np.testing.assert_array_equal(t.bits, rt.bits)
    np.testing.assert_array_equal(ours.query_batch(objs), ref.query_batch(refs))
    assert [ours.query(m) for m in objs[140:160]] == [ref.query(m) for m in refs[140:160]]
    # the device class sets the same bits as the host class, band by band
    dev = TorchMinHashLSHBloom(threshold=0.8, n=1000, fp=0.01, device="cpu")
    dev.insert_batch(sigs[:151])
    np.testing.assert_array_equal(dev.query_batch(sigs), ours.query_batch(objs))
    with pytest.raises(ValueError):
        ours.insert(MinHash(num_perm=64))
    save = tmp_path / "bands"
    disk = MinHashLSHBloom(threshold=0.8, num_perm=128, n=1000, fp=0.01, save_dir=str(save))
    disk.insert_batch(objs[:20])
    disk.sync()
    ref_disk = JaxBloom(threshold=0.8, num_perm=128, n=1000, fp=0.01, save_dir=str(save))
    assert all(ref_disk.query_batch(refs[:20]))
    t = BloomTable(item_count=100, fp=0.01, band_size=3)
    rt = JaxBloomTable(item_count=100, fp=0.01, band_size=3)
    for tab in (t, rt):
        tab.insert(np.array([1, 2, 3], dtype=np.uint64))
    np.testing.assert_array_equal(t.bits, rt.bits)
    with pytest.raises(RuntimeError):
        t.insert(np.array([1, 2], dtype=np.uint64))


def test_argument_checks():
    with pytest.raises(ValueError):
        TorchMinHashLSHBloom(threshold=1.5, device="cpu")
    with pytest.raises(ValueError):
        TorchMinHashLSHBloom(params=(20, 20), device="cpu")
    with pytest.raises(ValueError):
        MinHashLSHBloom(n=None, fp=0.01)
    with pytest.raises(ValueError):
        MinHashLSHBloom(n=10, fp=1.0)

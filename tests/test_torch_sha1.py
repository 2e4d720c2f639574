"""SHA1 of bytes tokens on the card's route, on the CPU: kernel 9's plain
twin against ``hashlib`` at the padding edges, the native pack's bytes and
offsets on ragged documents, ``bulk_signatures`` through the pack and the
twin against the host hasher and the JAX package, and the routes that keep
the host hasher."""

import hashlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from datasketch_tpu import MinHash as JaxMinHash
from datasketch_tpu_torch import MinHash, native
from datasketch_tpu_torch.hashfunc import sha1_hash32, xxhash_hash32
from datasketch_tpu_torch.kernels import sha1
from datasketch_tpu_torch.models import minhash as minhash_mod
from datasketch_tpu_torch.utils import profiling

torch.set_num_threads(2)

P = 128
# one compression up to 55 bytes; 56-63 spill the length, 64 the marker;
# 119 / 120 are the same edges one block later
EDGES = [0, 1, 10, 55, 56, 63, 64, 119, 120, 1000]


def _packed(tokens):
    data = np.frombuffer(b"".join(tokens), dtype=np.uint8).copy()
    offsets = np.zeros(len(tokens) + 1, dtype=np.int32)
    np.cumsum([len(t) for t in tokens], out=offsets[1:])
    return torch.from_numpy(data), torch.from_numpy(offsets)


def _want(tokens):
    return np.array([sha1_hash32(bytes(t)) for t in tokens], dtype=np.uint32)


@pytest.mark.parametrize("length", EDGES)
def test_plain_twin_equals_hashlib_at_the_padding_edges(length):
    rng = np.random.default_rng(length)
    tokens = [bytes(rng.integers(0, 256, length, dtype=np.uint8)) for _ in range(3)]
    tokens.insert(1, b"\x00" * length)
    data, offsets = _packed(tokens)
    got = sha1.sha1_hash32_plain(data, offsets, len(tokens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _want(tokens))
    digest = hashlib.sha1(tokens[0]).digest()
    assert int(got[0]) & 0xFFFFFFFF == int.from_bytes(digest[:4], "little")


def test_plain_twin_equals_hashlib_on_random_lengths_and_bytes():
    rng = np.random.default_rng(7)
    tokens = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
              for n in rng.integers(0, 131, 600)]
    data, offsets = _packed(tokens)
    out = torch.full((len(tokens),), 5, dtype=torch.int32)
    assert sha1.sha1_hash32(data, offsets, len(tokens), out) is out
    np.testing.assert_array_equal(out.numpy().view(np.uint32), _want(tokens))


def test_plain_twin_reads_only_the_first_n_tokens_and_any_offset():
    tokens = [b"abc", b"defgh", b"", b"ij"]
    data, offsets = _packed(tokens)
    # the tokens need not start at byte 0 of the buffer
    shifted = torch.cat([torch.zeros(5, dtype=torch.uint8), data])
    got = sha1.sha1_hash32_plain(shifted, offsets + 5, 3)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), _want(tokens[:3]))
    assert sha1.sha1_hash32_plain(data, offsets, 0).shape == (0,)


def _pack(docs, start=(0, 0), nbytes=4096, ntok=1024):
    data = np.zeros(nbytes, dtype=np.uint8)
    offsets = np.full(ntok + 1, -1, dtype=np.int32)
    pos, n, used, rest = native.pack_tokens(docs, start, data, offsets)
    return pos, n, used, rest, data, offsets


RAGGED = [
    [b"ab", bytearray(b"cde"), memoryview(b"f")],
    [],
    [b"", np.bytes_(b"gh"), b""],
    (b"tuple", b"doc"),
    [np.uint32(0x04030201), bytes(range(40))],
]


def test_pack_writes_ragged_documents_back_to_back():
    pos, n, used, rest, data, offsets = _pack(RAGGED)
    flat = [memoryview(t).tobytes() for d in RAGGED for t in d]
    assert pos == (len(RAGGED), 0) and rest == 0
    assert n == len(flat) and used == sum(map(len, flat))
    assert data[:used].tobytes() == b"".join(flat)
    np.testing.assert_array_equal(offsets[: n + 1], np.cumsum([0] + [len(t) for t in flat]))
    assert offsets[n + 1] == -1  # nothing written past the last end


@pytest.mark.parametrize("nbytes,ntok", [(7, 1024), (1024, 4), (1024, 0)])
def test_pack_stops_where_the_buffers_are_full_and_resumes(nbytes, ntok):
    """Pieces of at most ``ntok`` tokens and ``nbytes`` bytes: each is the
    next run of tokens, and the first says how many bytes it left."""
    flat = [memoryview(t).tobytes() for d in RAGGED for t in d]
    got, pos = [], (0, 0)
    while True:
        pos, n, used, rest, data, offsets = _pack(RAGGED, pos, nbytes, ntok)
        if not got:
            assert used + rest == sum(map(len, flat))
        if n == 0:
            break
        got.append([data[offsets[i]: offsets[i + 1]].tobytes() for i in range(n)])
        assert len(got[-1]) <= ntok and used <= nbytes
    pieces = sum(got, [])
    assert pieces == flat[: len(pieces)]
    if ntok == 0:
        assert got == [] and pos == (0, 0)
    elif nbytes >= 40:  # every token fits
        assert pieces == flat and pos == (len(RAGGED), 0) and len(got) == 3
    else:  # stuck before the 40-byte token, past the others
        assert len(pieces) == len(flat) - 1 and rest == 40


def _large_corpus(seed, n_docs=600):
    """~75,000 tokens (past the pack's split threshold of 65,536) of 0-59
    bytes, as lists of bytes."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
             for n in rng.integers(0, 60, 4000)]
    return [[vocab[i] for i in rng.integers(0, len(vocab), int(rng.integers(0, 250)))]
            for _ in range(n_docs)]


@pytest.mark.parametrize("variant", ["lists", "tuples_and_bytearrays", "a_memoryview_last",
                                     "room_for_all_but_the_last_byte"])
def test_a_large_pack_equals_its_tokens(variant):
    """A fresh pack this large is split over threads where every document
    is a list or tuple of bytes or bytearray tokens and all of them fit;
    otherwise it is one walk. Either way the bytes and offsets are the
    tokens'."""
    docs = _large_corpus(8)
    if variant == "tuples_and_bytearrays":
        docs = [tuple(d) if i % 2 else [bytearray(t) for t in d] for i, d in enumerate(docs)]
    elif variant == "a_memoryview_last":
        docs[-1] = docs[-1] + [memoryview(b"tail")]
    flat = [memoryview(t).tobytes() for d in docs for t in d]
    assert len(flat) > 65536
    total = sum(map(len, flat))
    nbytes = total - 1 if variant == "room_for_all_but_the_last_byte" else total + 64
    pos, n, used, rest, data, offsets = _pack(docs, nbytes=nbytes, ntok=len(flat) + 3)
    if variant == "room_for_all_but_the_last_byte":
        last = max(i for i, t in enumerate(flat) if t)
        assert n == last and rest == total - used and rest >= 1
        assert pos[0] < len(docs)
        flat = flat[:n]
    else:
        assert pos == (len(docs), 0) and n == len(flat) and rest == 0
    assert used == sum(map(len, flat)) and data[:used].tobytes() == b"".join(flat)
    np.testing.assert_array_equal(offsets[: n + 1], np.cumsum([0] + [len(t) for t in flat]))


def test_pack_rejects_what_it_cannot_read():
    with pytest.raises(TypeError, match="token 1 is int"):
        _pack([[b"a", 5]])
    with pytest.raises(TypeError):
        _pack([7])
    with pytest.raises(ValueError):
        native.pack_tokens([[b"a"]], (0, 0), np.zeros(4, np.int32), np.zeros(2, np.int32))


def _ragged_corpus(n_docs, seed, long_share=0.2):
    """Bytes documents of 0-60 tokens: mostly 10-byte words of a small
    vocabulary, a ``long_share`` of tokens of 0-130 random bytes."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(0, 256, 10, dtype=np.uint8)) for _ in range(300)]
    docs = []
    for _ in range(n_docs):
        doc = []
        for _ in range(int(rng.integers(0, 61))):
            if rng.random() < long_share:
                doc.append(bytes(rng.integers(0, 256, int(rng.integers(0, 131)), dtype=np.uint8)))
            else:
                doc.append(vocab[int(rng.integers(0, 300))])
        docs.append(doc)
    docs[2] = []
    docs[4] = [b""] * 3
    return docs


def test_bulk_signatures_through_the_pack_equal_the_host_hasher_and_jax():
    docs = _ragged_corpus(120, 3)
    assert max(len(t) for d in docs for t in d) > 55
    got = MinHash.bulk_signatures(docs, num_perm=P, seed=1, device="cpu")
    host = MinHash.bulk_signatures(docs, num_perm=P, seed=1, device="cpu",
                                   device_mode="disable")
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, JaxMinHash.bulk_signatures(docs, num_perm=P, seed=1))


def test_bulk_signatures_in_pieces_equal_one_piece(monkeypatch):
    docs = _ragged_corpus(80, 4)
    whole = MinHash.bulk_signatures(docs, num_perm=P, seed=3, device="cpu")
    monkeypatch.setattr(minhash_mod, "_PACK_TOKENS", 37)
    monkeypatch.setattr(minhash_mod, "_rings", {})
    packs = []
    real = native.pack_tokens

    def pack(*args):
        packs.append(args[1])
        return real(*args)

    monkeypatch.setattr(native, "pack_tokens", pack)
    got = MinHash.bulk_signatures(docs, num_perm=P, seed=3, device="cpu")
    np.testing.assert_array_equal(got, whole)
    assert len(packs) > 10 and packs[0] == (0, 0) and packs[1] != (0, 0)
    ring = minhash_mod._rings[torch.device("cpu")]
    assert ring._out == 0 and len(ring._free) == 1  # one caller reuses one CPU slot


def test_a_token_past_the_slot_bound_raises_and_frees_its_slot(monkeypatch):
    monkeypatch.setattr(minhash_mod, "_PACK_BYTES", 1 << 16)
    monkeypatch.setattr(minhash_mod, "_rings", {})
    with pytest.raises(ValueError, match="more than 65536 bytes"):
        MinHash.bulk_signatures([[b"x" * 70000, b"y"]], device="cpu")
    assert minhash_mod._rings[torch.device("cpu")]._out == 0


def test_the_card_route_counts_its_tokens_and_records_its_spans():
    docs = _ragged_corpus(50, 5)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        MinHash.bulk_signatures(docs, device="cpu", out="device")
    got = profiling.counters()
    profiling.reset_counters()
    assert got["front.card_sha1_tokens"] == sum(map(len, docs))
    names = {e.name for e in prof.events()}
    assert {"dstt.front.tokens", "dstt.front.sha1", "dstt.kernel.sha1"} <= names


@pytest.mark.parametrize("hashfunc", [xxhash_hash32, "device"])
def test_other_hash_functions_never_enter_the_pack(hashfunc, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the SHA1 pack ran for %r" % (hashfunc,))

    monkeypatch.setattr(native, "pack_tokens", refuse)
    monkeypatch.setattr(sha1, "sha1_hash32", refuse)
    if hashfunc == "device":
        docs = [np.arange(n, dtype=np.uint32) * 7 for n in (0, 5, 300)]
    else:
        docs = _ragged_corpus(40, 6)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = MinHash.bulk_signatures(docs, hashfunc=hashfunc, device="cpu")
    assert "front.card_sha1_tokens" not in profiling.counters()
    profiling.reset_counters()
    want = MinHash.bulk_signatures(docs, hashfunc=hashfunc, device="cpu",
                                   device_mode="disable")
    np.testing.assert_array_equal(got, want)

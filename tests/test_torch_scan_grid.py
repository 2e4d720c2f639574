"""The grid rule of kernels 2 and 4 (``kernels/tiling.grid``), a pure
function of (Q, N, SMs, resident blocks per SM): whole waves where the
queries allow, at least ``MIN_TILES`` tiles per split, at most
``MAX_SPLITS`` splits, and every row in exactly one split."""

import pytest

from datasketch_tpu_torch.kernels.tiling import MAX_SPLITS as _MAX_SPLITS
from datasketch_tpu_torch.kernels.tiling import MIN_TILES as _MIN_TILES
from datasketch_tpu_torch.kernels.tiling import QB as _QB
from datasketch_tpu_torch.kernels.tiling import RB as _RB
from datasketch_tpu_torch.kernels.tiling import grid as _grid

QS = (1, 2, 31, 32, 33, 100, 1000, 1024, 4096, 4224, 12672, 20000)
NS = (0, 1, 63, 64, 65, 511, 512, 1000, 4095, 4096, 20011, 32769, 100003, 1 << 20,
      (1 << 20) + 1, 1 << 24)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3, 4])
def test_grid_fills_whole_waves_and_covers_rows_once(sms, blocks_per_sm):
    slots = sms * blocks_per_sm
    for nq in QS:
        q_blocks = -(-nq // _QB)
        for n in NS:
            splits, rows = _grid(nq, n, sms, blocks_per_sm)
            case = (nq, n, sms, blocks_per_sm, splits, rows)
            assert 1 <= splits <= _MAX_SPLITS, case
            assert rows >= _RB and rows % _RB == 0, case
            # every row in exactly one split, no split empty
            assert (splits - 1) * rows < max(n, 1) <= splits * rows, case
            if splits > 1:
                assert rows >= _MIN_TILES * _RB, case
            if q_blocks > slots:
                assert splits == 1, case
                continue
            # one wave, as full as the caps allow (rounding a split up to
            # whole tiles loses at most an eighth of it)
            assert q_blocks * splits <= slots, case
            want = max(1, min(slots // q_blocks, _MAX_SPLITS, n // (_MIN_TILES * _RB)))
            assert splits * 9 > want * 8, case


def test_grid_at_the_timed_shape():
    """Q 1,024 on 132 SMs at 3 blocks each: 12 splits, 384 blocks, one
    wave (asking for 4 blocks per SM gave 17 splits, 544 blocks: 1.37
    waves)."""
    assert _grid(1024, 1 << 20, 132, 3) == (12, 87424)
    assert _grid(1024, 1 << 20, 132, 2)[0] == 8


def test_score_grid_at_the_timed_shape():
    """Kernel 4 at Q 1,024 x T 8,192 (the running top-k's tile): 32 query
    blocks, the db axis split to fill one wave of 132 SMs at 2 blocks each
    (its two tile buffers) or 3."""
    assert _grid(1024, 8192, 132, 2) == (8, 1024)
    assert _grid(1024, 8192, 132, 3) == (12, 704)


@pytest.mark.parametrize("nq", [1, 33, 77, 1000, 1024, 20000])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 4096, 8191, 8192])
def test_score_grid_covers_the_tile_once(nq, t):
    """Kernel 4's shapes (the card tests' and the callers'): every row in
    one split, at most one wave of blocks unless the queries alone fill
    more."""
    for blocks in (2, 3, 4):
        splits, rows = _grid(nq, t, 132, blocks)
        assert rows % _RB == 0 and (splits - 1) * rows < t <= splits * rows
        q_blocks = -(-nq // _QB)
        assert q_blocks * splits <= max(q_blocks, 132 * blocks)

"""Kernel 2's grid rule (``kernels/lsh_scan._grid``), a pure function of
(Q, N, SMs, resident blocks per SM): whole waves where the queries allow,
at least ``_MIN_TILES`` tiles per split, at most ``_MAX_SPLITS`` splits,
and every row in exactly one split."""

import pytest

from datasketch_tpu_torch.kernels.lsh_scan import _MAX_SPLITS, _MIN_TILES, _QB, _RB, _grid

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

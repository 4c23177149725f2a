"""The decode kernel's split chooser (piquant_tpu_torch/ops/cuda/
decode_attn2.py::split_tiles), a function of the shapes alone, at the
cache lengths `chip_smoke.py` drives (phases 3, 11, 12 and 14) and at
lengths that are not a multiple of the 64-position tile."""

import pytest

from piquant_tpu_torch.ops.cuda.decode_attn2 import (MAX_TILES, SPLITS, TILE,
                                                     split_tiles)


# (S, tiles a split, splits): S 2048 (Llama-3-8B, Qwen2-7B, Qwen3-30B-A3B,
# Gemma-2B / 7B and the V1 holds), 4096 (Gemma-3-12B), 8192 (Mistral-7B),
# then lengths off the tile, a long cache (16 tiles a split at most) and
# the shortest ones
@pytest.mark.parametrize("s_len,tps,nsplit", [
    (2048, 4, 8), (4096, 8, 8), (8192, 16, 8), (2047, 4, 8), (1000, 2, 8),
    (200, 1, 4), (32768, 16, 32), (64, 1, 1), (65, 1, 2), (1, 1, 1)])
def test_split_tiles(s_len, tps, nsplit):
    assert split_tiles(s_len) == (tps, nsplit)


def test_split_tiles_covers_every_length():
    for s_len in range(1, 40000, 7):
        tps, nsplit = split_tiles(s_len)
        tiles = -(-s_len // TILE)
        assert 1 <= tps <= MAX_TILES               # a split is whole tiles
        assert 1 <= nsplit <= tiles                # never more splits than tiles
        assert nsplit * tps >= tiles               # the splits cover S
        assert (nsplit - 1) * tps < tiles          # and none lies past it
        assert nsplit <= SPLITS or tps == MAX_TILES
        if tiles <= SPLITS:                        # short S: a tile a split
            assert (tps, nsplit) == (1, tiles)

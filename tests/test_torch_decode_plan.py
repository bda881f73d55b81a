"""The flash-decoding kernel's host-side plan (``kernels/_paged.py``):
``decode_form`` routes a call to the tensor-core or the CUDA-core form,
``decode_plan`` / ``tc_decode_plan`` pick each form's cluster split from
shapes alone, and ``split_key_ranges`` mirrors the key range each block of
a cluster walks (``csrc/decode_attention.cu``).  The kernel itself is held to the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _paged  # noqa: E402

H100_SMS = 132
# stablelm-1.6b's serving decode: 8 slots, 32 kv heads (MHA), 1024 keys in
# pages of 16
PHASE = dict(b=8, kvh=32, g=1, keys=1024, grain=16)


def _lengths(plan, bs):
    """Lengths at page and split edges: 1, BS - 1, BS, BS + 1, a split
    edge -1 / +0 / +1, and the whole cache."""
    edge = plan.split_keys
    return sorted({1, bs - 1, bs, bs + 1, edge - 1, edge, edge + 1,
                   plan.keys - 1, plan.keys} - {0})


def _cases():
    for b, kvh, g, keys, grain in [(8, 32, 1, 1024, 16), (5, 2, 4, 64, 16),
                                   (5, 2, 4, 512, 128), (3, 4, 8, 4096, 16),
                                   (8, 32, 1, 1024, 32), (2, 8, 4, 300, 32)]:
        for kv_offset in (0, 40, 512):
            yield b, kvh, g, keys, grain, kv_offset


@pytest.mark.parametrize("b,kvh,g,keys,grain,kv_offset", list(_cases()))
def test_split_key_ranges_cover_live_keys_once(b, kvh, g, keys, grain, kv_offset):
    plan = _paged.decode_plan(b, kvh, g, keys, grain, H100_SMS)
    assert 1 <= plan.n_split <= _paged.MAX_SPLIT
    assert plan.split_keys % grain == 0
    assert plan.n_split * plan.split_keys >= keys
    assert (plan.n_split - 1) * plan.split_keys < keys   # no split wholly past the cache
    for n in _lengths(plan, grain):
        length = kv_offset + n
        ranges = _paged.split_key_ranges(plan, length, kv_offset)
        assert len(ranges) == plan.n_split
        live = min(n, keys)
        walked = []
        for i, (start, stop) in enumerate(ranges):
            assert start == i * plan.split_keys and start % grain == 0
            assert start <= stop <= start + plan.split_keys
            walked += range(start, stop)
        assert walked == list(range(live))
    # a sequence that ends at or below the offset: every range empty
    for length in (0, kv_offset):
        assert all(a == z for a, z in _paged.split_key_ranges(plan, length, kv_offset))
    # no lengths (a whole slab): every key
    whole = _paged.split_key_ranges(plan, None)
    assert [k for a, z in whole for k in range(a, z)] == list(range(keys))


@pytest.mark.parametrize("keys", [4096, 32768])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("b,kvh", [(1, 8), (8, 32), (64, 8), (256, 32)])
def test_decode_plan_fits_cuda_limits(keys, g, b, kvh):
    for grain in (16, _paged.STAGE_KEYS):
        plan = _paged.decode_plan(b, kvh, g, keys, grain, H100_SMS)
        gx, gy, gz = plan.grid
        assert plan.cluster == (plan.n_split, 1, 1) and gx == plan.n_split
        assert 1 <= gx <= _paged.MAX_SPLIT and gy <= 65535 and gz <= 65535
        assert gy == kvh * plan.row_tiles and gz == b
        assert plan.row_tiles == -(-g // _paged.DECODE_ROWS)
        assert plan.split_keys % grain == 0
        # every warp of a block has a 32-key stage unless the cache is short
        assert plan.split_keys >= min(keys, _paged.DECODE_WARPS * _paged.STAGE_KEYS)


def test_decode_plan_phase_shapes():
    """The serving phase's shapes: 2 splits of 512 keys, 512 blocks, at
    least two blocks an SM (so the longest sequence no longer sets the
    time) and no more than one wave of BLOCKS_PER_SM."""
    plan = _paged.decode_plan(**PHASE, n_sm=H100_SMS)
    assert (plan.n_split, plan.split_keys) == (2, 512)
    assert plan.grid == (2, 32, 8)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks == 512
    assert 2 * H100_SMS <= blocks <= _paged.BLOCKS_PER_SM * H100_SMS
    # the dense slab at the same shapes splits alike
    assert _paged.decode_plan(8, 32, 1, 1024, _paged.STAGE_KEYS, H100_SMS) == plan


def test_decode_plan_adapts_to_the_grid():
    """A grid that fills the card without splits is not split further, a
    small grid over a long cache takes every split, a short cache is not
    cut below one stage a warp, and G past 8 takes row tiles."""
    big = _paged.decode_plan(256, 32, 1, 1024, 16, H100_SMS)
    assert big.n_split == 1 and big.split_keys == 1024
    long = _paged.decode_plan(1, 8, 8, 32768, 16, H100_SMS)
    assert long.n_split == _paged.MAX_SPLIT and long.split_keys == 4096
    short = _paged.decode_plan(1, 1, 1, 100, 16, H100_SMS)
    assert short.n_split == 1 and short.split_keys == 112
    tiles = _paged.decode_plan(2, 2, 12, 256, 16, H100_SMS)
    assert tiles.row_tiles == 2 and tiles.grid[1] == 4


@pytest.mark.parametrize("bad", [dict(b=0), dict(kvh=0), dict(g=0), dict(keys=0),
                                 dict(grain=0), dict(n_sm=0), dict(kvh=70000),
                                 dict(b=70000)])
def test_decode_plan_refuses(bad):
    kw = dict(PHASE, n_sm=H100_SMS)
    kw.update(bad)
    with pytest.raises(ValueError, match="decode plan"):
        _paged.decode_plan(**kw)


# The form decode_form routes each (query dtype, D) to at G = 1, 2, 3, 4, 8
ROUTE_GROUPS = (1, 2, 3, 4, 8)
ROUTE_TABLE = {
    (torch.bfloat16, 16): ("cuda", "cuda", "cuda", "cuda", "cuda"),
    (torch.bfloat16, 64): ("cuda", "tc", "tc", "tc", "tc"),
    (torch.bfloat16, 112): ("tc", "tc", "tc", "tc", "tc"),
    (torch.bfloat16, 128): ("tc", "tc", "tc", "tc", "tc"),
    (torch.float32, 16): ("cuda", "cuda", "cuda", "cuda", "cuda"),
    (torch.float32, 64): ("cuda", "cuda", "cuda", "cuda", "cuda"),
    (torch.float32, 112): ("cuda", "cuda", "cuda", "cuda", "cuda"),
    (torch.float32, 128): ("cuda", "cuda", "cuda", "cuda", "cuda"),
}
ROUTES = [(dt, d, g, form) for (dt, d), forms in ROUTE_TABLE.items()
          for g, form in zip(ROUTE_GROUPS, forms)]


@pytest.mark.parametrize("dtype,d,g,form", ROUTES)
def test_decode_form_routes(dtype, d, g, form):
    """bf16 queries at head dims 112 / 128 (any G) and at 64 with G > 1 take
    the tensor-core form; f32 queries and G = 1 up to 64 keep the CUDA-core
    form (rows 1, 1q, 1s, 7 and every fp32 check)."""
    assert _paged.decode_form(dtype, d, g) == form


# (b, kvh, g, d, keys, grain): the readings' shapes (rows 1g, 1o, 7o, 1h,
# 7h, granite-3-2b's G 4 slab) and G 2, 4, 8 at D 128 and 64, a long cache
TC_ROWS = {"1g": (8, 8, 3, 128, 1024, 16), "1o": (8, 16, 1, 128, 1024, 16),
           "7o": (8, 16, 1, 128, 1024, 16), "1h": (8, 32, 1, 112, 1024, 16),
           "7h": (8, 32, 1, 112, 1024, 16), "7g": (8, 8, 4, 64, 1024, 16),
           "g2": (8, 8, 2, 128, 1024, 16), "g4": (8, 8, 4, 128, 1024, 16),
           "g8": (8, 8, 8, 128, 1024, 16), "g4_64": (8, 8, 4, 64, 1024, 16),
           "g12": (2, 2, 12, 128, 300, 16), "long": (1, 8, 8, 128, 32768, 16),
           "bs128": (8, 8, 3, 128, 1024, 128)}


@pytest.mark.parametrize("row", list(TC_ROWS))
def test_tc_decode_plan_shapes(row):
    """The tensor-core form's plan: as many ranges as TC_SPLIT_KEYS-key
    ranges cover the cache, on the grain (at most 8, none wholly past the
    cache), row tiles of 8 whatever G, and at 1024 keys (the rows' caches) 4 splits of
    256 keys: every busy block's 4 warps walk 4 stages of 16 keys,
    minitron-4b's 64 (sequence, kv head) pairs included."""
    b, kvh, g, d, keys, grain = TC_ROWS[row]
    plan = _paged.tc_decode_plan(b, kvh, g, d, keys, grain)
    assert 1 <= plan.n_split <= _paged.MAX_SPLIT and plan.split_keys % grain == 0
    assert plan.n_split * plan.split_keys >= keys > (plan.n_split - 1) * plan.split_keys
    assert plan.n_split <= min(_paged.MAX_SPLIT, -(-keys // _paged.TC_SPLIT_KEYS))
    assert plan.row_tiles == -(-g // _paged.DECODE_ROWS)
    assert plan.grid == (plan.n_split, kvh * plan.row_tiles, b)
    assert plan.cluster == (plan.n_split, 1, 1)
    if keys == 1024 and grain <= _paged.TC_SPLIT_KEYS:
        assert (plan.n_split, plan.split_keys) == (4, 256)
        assert plan.split_keys // _paged.TC_STAGE_KEYS // _paged.DECODE_WARPS == 4
    # the ranges the blocks walk cover the live keys once
    for n in (1, plan.split_keys, plan.split_keys + 1, keys):
        walked = [k for a, z in _paged.split_key_ranges(plan, n) for k in range(a, z)]
        assert walked == list(range(min(n, keys)))


def test_tc_decode_plan_edges_and_refusals():
    """A short cache takes one split, a long one all 8, and the form refuses
    a head dim it has no instantiation for and empty shapes."""
    short = _paged.tc_decode_plan(4, 2, 2, 64, 100, 16)
    assert (short.n_split, short.split_keys) == (1, 112)
    long = _paged.tc_decode_plan(1, 8, 8, 128, 32768, 16)
    assert (long.n_split, long.split_keys) == (_paged.MAX_SPLIT, 4096)
    with pytest.raises(ValueError, match="head dim"):
        _paged.tc_decode_plan(8, 8, 4, 16, 1024, 16)
    with pytest.raises(ValueError, match="decode plan"):
        _paged.tc_decode_plan(0, 8, 4, 128, 1024, 16)

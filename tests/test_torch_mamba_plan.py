"""The bf16 Mamba2 backward's host-side plan (``kernels/mamba_chunk.py:
bwd_plan``): the heads a block of the chunk-parallel gradient kernel covers,
chosen from shapes and the card's resident-block slots alone, and the head groups that G makes as the kernel
walks them (``csrc/mamba2.cu``, ``mamba2_bwd_tc_kernel``: group k takes
heads k G .. min(H, (k + 1) G)).  The kernels themselves are held to the
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import mamba_chunk as kmamba  # noqa: E402

# an H100 SXM: 132 SMs, each holding 2 blocks of the gradient kernel (what
# CUDA's occupancy calculator reads there, ``kmamba.bwd_slots``)
SLOTS = 132 * 2

# (B, S, H): zamba2-7b's training shapes (2 x 4096 tokens, 112 heads), the
# card tests' (a ragged S, a head count no G but 1 and 20 divides well),
# the reduced model's and one batch row of a long sequence
CASES = [(2, 4096, 112), (2, 200, 20), (2, 70, 3), (1, 33, 2), (1, 16384, 112),
         (8, 4096, 112), (2, 100, 3)]


def _groups(h, g):
    return [range(k * g, min(h, (k + 1) * g)) for k in range(-(-h // g))]


def _score(b, s, h, g):
    ng = -(-h // g)
    blocks = b * kmamba.n_chunks(s) * ng
    return blocks / (-(-blocks // SLOTS) * SLOTS) * h / (ng * g)


@pytest.mark.parametrize("b,s,h", CASES)
def test_groups_cover_every_head_once(b, s, h):
    g = kmamba.bwd_plan(b, s, h, SLOTS)
    assert 1 <= g <= h
    heads = [i for grp in _groups(h, g) for i in grp]
    assert heads == list(range(h))
    assert all(len(grp) >= 1 for grp in _groups(h, g))


@pytest.mark.parametrize("b,s,h", CASES)
def test_plan_takes_the_fewest_groups_near_the_best_score(b, s, h):
    """G's grid scores within PLAN_SLACK of the best G's, and every G with
    fewer groups scores below that."""
    g = kmamba.bwd_plan(b, s, h, SLOTS)
    best = max(_score(b, s, h, other) for other in range(1, h + 1))
    floor = (1 - kmamba.PLAN_SLACK) * best
    assert _score(b, s, h, g) >= floor
    for other in range(g + 1, h + 1):
        if -(-h // other) < -(-h // g):
            assert _score(b, s, h, other) < floor


def test_zamba2_7b_fills_one_wave_without_a_partial_group():
    """At 2 x 4096 tokens and 112 heads: 2 groups of 56 heads, 256 blocks in
    the 264 slots of one wave, every group full (dB / dC partials [2, 4096,
    2, 64] f32, 4.2 MB each)."""
    g = kmamba.bwd_plan(2, 4096, 112, SLOTS)
    assert g == 56
    assert 2 * 64 * (112 // g) <= SLOTS
    assert 112 % g == 0


def test_short_grids_take_one_head_a_block():
    """A grid of a few chunks cannot fill the card: one head a block."""
    assert kmamba.bwd_plan(2, 200, 20, SLOTS) == 1
    assert kmamba.bwd_plan(1, 33, 2, SLOTS) == 1
    assert kmamba.bwd_plan(2, 70, 3, SLOTS) == 1


def test_plan_follows_the_slot_count():
    """Twice the SMs take twice the groups at zamba2-7b's shapes."""
    assert kmamba.bwd_plan(2, 4096, 112, 2 * SLOTS) == 28

"""Port parity, the lane planner and the §3.3 split cost model:
``repro_torch.core.planner`` / ``mapping`` against the JAX package's
``repro.core.planner`` / ``mapping``.

The operator inventory of every assigned arch at every assigned shape is
the reference's, field for field.  The plans and the lane table are the
reference's under its own hardware values (``TPU_V5E``, passed to the port
as an ``HWParams``), its ``mxu`` lane read as the port's tensor lane and
``vpu`` as its stream lane; every float is held with ``==``.  Under the
port's default, the card's datasheet values, the reference's lane-crossover
properties hold.  ``choose_fc_split`` and ``megatron_block_bytes`` equal
the reference's on a grid.
"""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

from repro.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro.core import mapping as jmapping  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import mapping as tmapping  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core.planner import Lane, OpProfile  # noqa: E402

LANES = {"mxu": Lane.TENSOR, "vpu": Lane.STREAM}
TPU_VALUES = tplanner.HWParams(**dataclasses.asdict(jplanner.TPU_V5E))
T_SHAPE = {s.name: s for s in T_SHAPES}


def _op(o):
    return (o.name, o.m, o.k, o.n, o.count, o.weight_static, o.dtype_bytes,
            o.flops, o.bytes_hbm, o.intensity)


def _plan(p, lane):
    return (_op(p.op), lane, p.bm, p.bn, p.compute_s, p.memory_s, p.bound)


@pytest.mark.parametrize("arch", ARCHS)
def test_profiles_plans_and_lane_table_match_reference(arch):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    for shape in SHAPES:
        tshape = T_SHAPE[shape.name]
        assert [_op(o) for o in tplanner.model_op_profiles(tcfg, tshape)] == \
            [_op(o) for o in jplanner.model_op_profiles(jcfg, shape)], shape.name
        for chips in (1, 8):
            tp = tplanner.plan_model(tcfg, tshape, TPU_VALUES, chips)
            jp = jplanner.plan_model(jcfg, shape, jplanner.TPU_V5E, chips)
            assert [_plan(p, p.lane) for p in tp] == \
                [_plan(p, LANES[p.lane.value]) for p in jp], (shape.name, chips)
        trows = tplanner.lane_table(tcfg, tshape, TPU_VALUES).splitlines()
        jrows = jplanner.lane_table(jcfg, shape, jplanner.TPU_V5E).splitlines()
        names = {"mxu": "tensor", "vpu": "stream"}
        assert [r.split() for r in trows] == \
            [[names.get(w, w) for w in r.split()] for r in jrows]


def test_defaults_are_the_h100_datasheet():
    hw = tplanner.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.vmem_bytes, hw.mxu_align) == \
        (989e12, 3.35e12, 232448, 64)
    assert hw.ici_bw * hw.ici_links * 2 == 900e9     # NVLink 4, both ways
    assert tplanner.classify(OpProfile("fc", 8, 2048, 2048)) == Lane.STREAM


def test_lane_crossover_with_batch():
    """Fig. 4B's crossover on the card: an FC moves from the streaming lane
    to the tensor lane as batch (m) grows."""
    lo = tplanner.classify(OpProfile("fc", 1, 4096, 4096))
    hi = tplanner.classify(OpProfile("fc", 4096, 4096, 4096))
    assert lo == Lane.STREAM and hi == Lane.TENSOR
    for s in (4096, 32768, 524288):
        op = OpProfile("attn_sv", 1, s, 128, weight_static=False)
        assert tplanner.classify(op) == Lane.STREAM


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(m=st.integers(1, 1 << 20), k=st.sampled_from([512, 4096]),
                  n=st.sampled_from([512, 8192]))
def test_lane_monotone_in_m(m, k, n):
    """The reference's property under the card's default: once on the
    tensor lane, any larger m stays there."""
    if tplanner.classify(OpProfile("fc", m, k, n)) == Lane.TENSOR:
        assert tplanner.classify(OpProfile("fc", m * 2, k, n)) == Lane.TENSOR


def test_split_cost_model_matches_reference():
    for m, k, n, tp, sharded in itertools.product(
            (1, 1024), (512, 16384), (512, 16384), (2, 16), (False, True)):
        t = tmapping.choose_fc_split(m, k, n, tp, input_sharded=sharded)
        j = jmapping.choose_fc_split(m, k, n, tp, input_sharded=sharded)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
    for m, d, ff, tp in itertools.product((1, 4096), (2048, 5120),
                                          (5632, 13824), (1, 2, 16)):
        assert tmapping.megatron_block_bytes(m, d, ff, tp) == \
            jmapping.megatron_block_bytes(m, d, ff, tp)
    c = tmapping.choose_fc_split(m=1024, k=16384, n=512, tp=16, input_sharded=True)
    assert c.split == "input"

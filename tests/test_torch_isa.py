"""Port parity, the hierarchical ISA: ``repro_torch.core.isa`` against the
JAX package's ``repro.core.isa``.

Plans: ``lower`` gives the reference's packets, field for field (kind,
buffers, steps, ``iter_num``, tree roots, exchange modes), for the softmax
program at 4-8 rounds and the rope program, fused and unfused, and for any
chain of scalar ops (a hypothesis property at few examples).  Execution:
every packet kind through a tiny program on the port's ``Machine`` against
the reference's, on the same f32 numpy inputs.  Elementwise packets take the
same IEEE f32 steps on both sides and are held bit for bit; packets that sum
(the bank reduce, the DRAM MAC, the SRAM product, and the softmax built on
them) may add in another order and are held to 1e-6 relative plus 1e-6 of
the largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

import jax.numpy as jnp  # noqa: E402

from repro.core import isa as jisa  # noqa: E402
from repro_torch.core import isa as tisa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _sum_close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _packet_fields(p):
    """A packet as a comparable tuple: its class name and its fields (a
    scalar packet's steps as (op, arg) pairs, with its iter_num)."""
    name = type(p).__name__
    if name == "ScalarPacket":
        return (name, p.src, p.dst, tuple((s.op, s.arg) for s in p.steps),
                p.iter_num)
    return (name,) + tuple(vars(p).values())


def _plans_equal(tplan, jplan):
    assert [_packet_fields(p) for p in tplan.packets] == \
        [_packet_fields(p) for p in jplan.packets]
    assert tplan.n_packets() == jplan.n_packets()
    assert tplan.dram_roundtrips() == jplan.dram_roundtrips()
    assert tplan.alu_ops() == jplan.alu_ops()


def _to_row(instrs, module):
    return [module.RowInstr(i.kind, i.op, i.src, i.dst, i.num1, i.num2)
            for i in instrs]


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("rounds", [4, 5, 6, 7, 8])
def test_softmax_lowering_matches_reference(rounds, fuse):
    tprog, jprog = tisa.softmax_program(rounds), jisa.softmax_program(rounds)
    assert _to_row(tprog, jisa) == jprog
    _plans_equal(tisa.lower(tprog, fuse=fuse), jisa.lower(jprog, fuse=fuse))


@pytest.mark.parametrize("fuse", [True, False])
def test_rope_lowering_matches_reference(fuse):
    tprog, jprog = tisa.rope_program(), jisa.rope_program()
    assert _to_row(tprog, jisa) == jprog
    _plans_equal(tisa.lower(tprog, fuse=fuse), jisa.lower(jprog, fuse=fuse))


@hypothesis.settings(max_examples=8, deadline=None)
@hypothesis.given(
    ops=st.lists(st.tuples(st.sampled_from(["+=", "-=", "*=", "/="]),
                           st.floats(0.5, 2.0)), min_size=1, max_size=12),
    seed=st.integers(0, 2 ** 16))
def test_scalar_chain_fusion_property(ops, seed):
    """The reference's property: any chain of NoC_Scalar constant ops fuses
    into one packet and runs as its unfused plan does; here also with the
    reference's plans packet for packet and its outputs bit for bit."""
    x = np.random.default_rng(seed).normal(size=(4, 8)).astype(np.float32)
    prog = [tisa.RowInstr("NoC_Scalar", op, "x" if i == 0 else "t", "t",
                          None, c) for i, (op, c) in enumerate(ops)]
    pf, pu = tisa.lower(prog, fuse=True), tisa.lower(prog, fuse=False)
    assert pf.n_packets() == 1 and pu.n_packets() == len(ops)
    for fuse, plan in ((True, pf), (False, pu)):
        _plans_equal(plan, jisa.lower(_to_row(prog, jisa), fuse=fuse))
    got_f = tisa.Machine({"x": torch.from_numpy(x)}).run(pf)["t"]
    got_u = tisa.Machine({"x": torch.from_numpy(x)}).run(pu)["t"]
    want = jisa.Machine({"x": jnp.asarray(x)}).run(
        jisa.lower(_to_row(prog, jisa)))["t"]
    np.testing.assert_array_equal(_np(got_f), _np(got_u))
    np.testing.assert_array_equal(_np(got_f), _np(want))


def _run_both(prog, buffers):
    """One program through both machines from the same numpy buffers."""
    tbuf = tisa.Machine({k: torch.from_numpy(v) for k, v in buffers.items()}
                        ).run(tisa.lower(prog))
    jbuf = jisa.Machine({k: jnp.asarray(v) for k, v in buffers.items()}
                        ).run(jisa.lower(_to_row(prog, jisa)))
    return tbuf, jbuf


R = tisa.RowInstr

# (name, program, sums): every packet kind; ``sums`` marks the outputs
# that add (held to the sum tolerance, the rest bit for bit)
PROGRAMS = [
    ("scalar_named_self",
     [R("NoC_Scalar", "*=", "x", "a", None, "w"),
      R("NoC_Scalar", "max=", "a", "a", None, 0.25),
      R("NoC_Scalar", "-=", "a", "a", None, "x"),
      R("NoC_Scalar", "*=", "a", "a", None, "self"),
      R("NoC_Scalar", "/=", "a", "y", None, 3.0)], ()),
    ("reduce_add", [R("NoC_Reduce", "+=", "x", "y", None, 0)], ("y",)),
    ("reduce_max_root3", [R("NoC_Reduce", "max=", "x", "y", None, 3)], ()),
    ("reduce_mul", [R("NoC_Reduce", "*=", "x", "y", None, 1)], ()),
    ("bcast", [R("NoC_BCast", None, "x", "y", None, 5)], ()),
    ("exchange_R+", [R("NoC_Exchange", "R+", "x", "y", 1, 2)], ()),
    ("exchange_R-", [R("NoC_Exchange", "R-", "x", "y", 3, 4)], ()),
    ("exchange_T+", [R("NoC_Exchange", "T+", "x", "y", 1, 4)], ()),
    ("exchange_T-", [R("NoC_Exchange", "T-", "x", "y", 2, 8)], ()),
    ("sram", [R("SRAM_Write", None, "wt", ""),
              R("SRAM_Compute", None, "x", "y")], ("y",)),
    ("dram_ewmul", [R("DRAM_EWMUL", None, "x", "y", None, "w")], ()),
    ("dram_mac", [R("DRAM_MAC", "+=", "x", "y")], ("y",)),
    ("noc_access", [R("NoC_Access", None, "x", "y")], ()),
]


@pytest.mark.parametrize("name,prog,sums", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_packet_kinds_match_reference(name, prog, sums):
    rng = np.random.default_rng(3)
    banks, width = 8, 16
    bufs = {"x": rng.normal(size=(banks, width)).astype(np.float32),
            "w": rng.normal(size=(banks, width)).astype(np.float32),
            "wt": rng.normal(size=(banks, width, 5)).astype(np.float32)}
    tbuf, jbuf = _run_both(prog, bufs)
    assert set(tbuf) == set(jbuf)
    for key in jbuf:
        assert tuple(tbuf[key].shape) == tuple(jbuf[key].shape), key
        if key in sums:
            _sum_close(tbuf[key], jbuf[key])
        else:
            np.testing.assert_array_equal(_np(tbuf[key]), _np(jbuf[key]),
                                          err_msg=key)


def test_sram_compute_before_write_raises():
    prog = [R("SRAM_Compute", None, "x", "y")]
    x = np.ones((2, 4), np.float32)
    with pytest.raises(RuntimeError, match="before SRAM_Write"):
        tisa.Machine({"x": torch.from_numpy(x)}).run(tisa.lower(prog))
    with pytest.raises(AssertionError):   # the reference's form of the same
        jisa.Machine({"x": jnp.asarray(x)}).run(jisa.lower(_to_row(prog, jisa)))


@pytest.mark.parametrize("rounds", [6, 8])
def test_softmax_execute_matches_reference(rounds):
    x = np.random.default_rng(4).normal(size=(16, 32)).astype(np.float32)
    ty, tplan = tisa.softmax_execute(torch.from_numpy(x), rounds)
    jy, jplan = jisa.softmax_execute(jnp.asarray(x), rounds)
    _plans_equal(tplan, jplan)
    _sum_close(ty, jy)
    # unfused takes the same steps: the same bits
    np.testing.assert_array_equal(
        _np(ty), _np(tisa.softmax_execute(torch.from_numpy(x), rounds,
                                          fuse=False)[0]))


def test_rope_execute_matches_reference_and_kernel_plain():
    """The Fig. 12 program against the reference's and the port's plain
    rope (interleaved cos / sin from ``ref.rope_cos_sin``)."""
    s, d = 6, 16
    x = np.random.default_rng(5).normal(size=(s, d)).astype(np.float32)
    pos = torch.arange(s, dtype=torch.float32)[None]
    cos, sin = tref.rope_cos_sin(pos, d, 1e4)
    cos2 = torch.repeat_interleave(cos, 2, -1)[0]
    sin2 = torch.repeat_interleave(sin, 2, -1)[0]
    ty, tplan = tisa.rope_execute(torch.from_numpy(x), cos2, sin2)
    jy, jplan = jisa.rope_execute(jnp.asarray(x), jnp.asarray(cos2.numpy()),
                                  jnp.asarray(sin2.numpy()))
    _plans_equal(tplan, jplan)
    np.testing.assert_array_equal(_np(ty), _np(jy))
    want = tref.apply_rope(torch.from_numpy(x)[None, :, None, :],
                           torch.arange(s, dtype=torch.int32)[None], 1e4)
    np.testing.assert_allclose(_np(ty), want[0, :, 0].numpy(), rtol=1e-5,
                               atol=1e-5)

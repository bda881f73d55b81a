"""Port parity, the paper's analytical model: ``repro_torch.pimsim``
(``params``, ``ops``, ``system``) against the JAX package's ``repro.pimsim``.

Both sides are the same Python float arithmetic in the same order, so every
number is held with ``==``: the hardware constants field by field, every
``pimsim.ops`` cost function over a grid of shapes, and ``simulate``'s
breakdown, ``token_latency`` and ``decode_throughput`` for every paper model
and system over a batch / context / tensor-parallel grid, both phases.
"""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro.configs.paper_models import PAPER_MODELS as J_MODELS  # noqa: E402
from repro.pimsim import ops as jops  # noqa: E402
from repro.pimsim import params as jparams  # noqa: E402
from repro.pimsim import system as jsys  # noqa: E402
from repro_torch.configs.paper_models import PAPER_MODELS as T_MODELS  # noqa: E402
from repro_torch.pimsim import ops as tops  # noqa: E402
from repro_torch.pimsim import params as tparams  # noqa: E402
from repro_torch.pimsim import system as tsys  # noqa: E402

SYSTEMS = ("cent", "cent_curry", "compair_base", "compair_opt", "attacc")
GRID = list(itertools.product((1, 64), (128, 4096), (1, 8)))
HW_VARIANTS = {"default": {}, "rounds8_devices16": dict(curry_rounds=8, devices=16)}


def _cost(c):
    return (c.t, c.e)


def test_hardware_constants_equal():
    for name in ("DramPim", "SramPim", "Noc", "Nlu", "Cxl", "Gpu", "HbmPim",
                 "CompairHW"):
        t, j = getattr(tparams, name)(), getattr(jparams, name)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    assert dataclasses.asdict(tparams.DEFAULT) == dataclasses.asdict(jparams.DEFAULT)
    hw_t, hw_j = tparams.DEFAULT.with_(devices=8), jparams.DEFAULT.with_(devices=8)
    assert dataclasses.asdict(hw_t) == dataclasses.asdict(hw_j)
    for name in ("banks", "bank_flops", "row_overhead_s"):
        assert getattr(tparams.DramPim(), name) == getattr(jparams.DramPim(), name)
    assert tparams.SramPim().bank_flops() == jparams.SramPim().bank_flops()
    assert tparams.SramPim().macs_per_access == jparams.SramPim().macs_per_access
    assert tparams.Noc().alu_throughput == jparams.Noc().alu_throughput


def test_cost_algebra():
    a, b = tops.Cost(1.5, 2.0), tops.Cost(0.5, 3.0)
    ja, jb = jops.Cost(1.5, 2.0), jops.Cost(0.5, 3.0)
    assert _cost(a + b) == _cost(ja + jb)
    assert _cost(a.par(b)) == _cost(ja.par(jb))


# (function, argument tuples): every cost function of pimsim.ops
OPS_GRID = {
    "dram_fc": [dict(m=m, k=k, n=n, banks=b) for m, k, n, b in itertools.product(
        (1, 8, 512), (2048, 5120), (256, 13824), (64, 512))],
    "dram_attention": [dict(batch=b, heads=h, s_ctx=s, hd=d, banks=n)
                       for b, h, s, d, n in itertools.product(
                           (1, 32), (8, 64), (128, 32768), (64, 128), (512,))],
    "sram_fc": [dict(m=m, k=k, n=n, banks=b, decoupled=dec, in_dim=i, out_dim=o,
                     input_split_groups=g)
                for m, k, n, b, dec, (i, o, g) in itertools.product(
                    (1, 8, 512), (2048, 5120), (256, 13824), (512,), (False, True),
                    ((None, None, 1), (256, 16, 2), (512, 8, 1)))],
    "nonlinear_centralized": [dict(elements=e, ops_per_elem=o)
                              for e in (1, 4096, 10 ** 7) for o in (4, 8)],
    "nonlinear_noc": [dict(elements=e, ops_per_elem=o, channels_active=c)
                      for e in (1, 4096, 10 ** 7) for o in (None, 6)
                      for c in (None, 8)],
    "reduce_tree_noc": [dict(vec_elems=v, fan_in=f) for v in (1, 4096)
                        for f in (1, 2, 16, 17)],
    "reduce_global_buffer": [dict(vec_elems=v, fan_in=f) for v in (1, 4096)
                             for f in (1, 16)],
    "cxl_allreduce": [dict(bytes_per_device=b, tp=t) for b in (2.0, 1e6)
                      for t in (1, 2, 8)],
    "cxl_broadcast": [dict(bytes_=b, tp=t) for b in (2.0, 1e6) for t in (1, 8)],
}


@pytest.mark.parametrize("hw", sorted(HW_VARIANTS))
@pytest.mark.parametrize("fn", sorted(OPS_GRID))
def test_ops_bit_equal(fn, hw):
    th = tparams.DEFAULT.with_(**HW_VARIANTS[hw])
    jh = jparams.DEFAULT.with_(**HW_VARIANTS[hw])
    for kw in OPS_GRID[fn]:
        assert _cost(getattr(tops, fn)(th, **kw)) == \
            _cost(getattr(jops, fn)(jh, **kw)), (fn, kw)


@pytest.mark.parametrize("model", sorted(J_MODELS))
def test_simulate_bit_equal(model):
    tcfg, jcfg = T_MODELS[model], J_MODELS[model]
    for system, phase, (batch, s_ctx, tp) in itertools.product(
            SYSTEMS, ("decode", "prefill"), GRID):
        kw = dict(batch=batch, s_ctx=s_ctx, phase=phase, system=system, tp=tp)
        t = tsys.simulate(tcfg, **kw).as_dict()
        j = jsys.simulate(jcfg, **kw).as_dict()
        assert t == j, (model, kw)
    assert tsys._fc_layers(tcfg) == jsys._fc_layers(jcfg)


@pytest.mark.parametrize("model", sorted(J_MODELS))
def test_mappings_latency_and_throughput_bit_equal(model):
    tcfg, jcfg = T_MODELS[model], J_MODELS[model]
    th = tparams.DEFAULT.with_(curry_rounds=8)
    jh = jparams.DEFAULT.with_(curry_rounds=8)
    for mapping, system, batch in itertools.product(
            ("auto", "output", "input"), ("compair_base", "compair_opt"), (1, 64)):
        kw = dict(batch=batch, s_ctx=2048, phase="prefill", system=system,
                  mapping=mapping, sram_min_batch=4)
        assert tsys.simulate(tcfg, hw=th, **kw).as_dict() == \
            jsys.simulate(jcfg, hw=jh, **kw).as_dict(), kw
    for system, batch, tp in itertools.product(SYSTEMS, (1, 64), (1, 8)):
        kw = dict(batch=batch, s_ctx=4096, system=system, tp=tp)
        assert tsys.token_latency(tcfg, **kw) == jsys.token_latency(jcfg, **kw)
        assert tsys.decode_throughput(tcfg, devices=32, **kw) == \
            jsys.decode_throughput(jcfg, devices=32, **kw)
        assert tsys.decode_throughput(tcfg, hw=th, devices=16, **kw) == \
            jsys.decode_throughput(jcfg, hw=jh, devices=16, **kw)

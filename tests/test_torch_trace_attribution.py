"""The traces' attribution rule (``repro_torch/launch/_trace.py``) on a real
profile of a reduced olmoe-1b-7b loss and gradient on the CPU, ranged as
``launch/trace_train.py`` ranges its traced step.  The CPU profile has no
device kernels, so each GEMM op (``aten::mm`` / ``aten::bmm``) stands in
for the kernel it would launch on the card.  Every GEMM of the MoE layers
lands in its group and no other does: the expert GEMMs are 3 a layer in
the forward, 3 more in remat's recompute and 6 in the backward; the
dispatch's are the router's and the combine's (its gated sum), 1, 1 and 2
each.  The recompute runs inside a backward node, under the fence that
keeps it out of that node's group: where the node is the dispatch's own,
the GEMMs it recomputes outside the ranges still stay GEMMs, and a
backward on another thread than its forward (as a card's) matches each
node by its forward thread as well as its sequence number."""
from collections import namedtuple

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import _trace, trace_train  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

Kernel = namedtuple("Kernel", "name duration")
GEMM_OPS = ("aten::mm", "aten::bmm")


def _profile(remat: bool):
    """Profiled loss and gradients of reduced olmoe under trace_train's
    ranges -> (cfg, events, ranges, launched), ``launched`` giving each
    GEMM op one stand-in kernel (the same object on every call)."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    state = TS.init_state(cfg, seed=0, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    patches, ranges = trace_train.traced_ranges()
    loss_fn = TS.value_and_grad(TS.make_loss_fn(cfg, remat=remat))
    with _trace.patched(patches), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loss_fn(state.params, batch)
    stand_in = {}

    def launched(ev):
        if ev.name not in GEMM_OPS:
            return []
        if id(ev) not in stand_in:
            stand_in[id(ev)] = [Kernel(f"gemm {ev.name}", 1.0)]
        return stand_in[id(ev)]
    return cfg, prof.events(), ranges, launched


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_moe_training_trace_attribution(remat):
    cfg, events, ranges, launched = _profile(remat)
    L = cfg.n_layers
    taken = _trace.attribute(events, ranges, trace_train.MOVED_FROM,
                             trace_train._group, launched)
    moved = {}
    for src, to, _ in taken.values():
        assert src == _trace.GEMMS
        moved[to] = moved.get(to, 0) + 1
    passes = 2 if remat else 1          # the forward, and the recompute
    assert moved == {"expert GEMMs": (3 * passes + 6) * L,
                     "MoE dispatch": 2 * (passes + 2) * L}
    gemms = sum(len(launched(ev)) for ev in events)
    groups = _trace.regroup({"gemm": [float(gemms), gemms]}, taken,
                            lambda name: _trace.GEMMS)
    assert groups[_trace.GEMMS][1] == gemms - sum(moved.values()) > 0
    fence = [ev for ev in events if ev.name == trace_train.FENCE]
    if remat:                           # the recompute ran inside a backward node
        assert len(fence) == 2 * L
        inside = [ev for ev in fence if ev.cpu_parent is not None]
        assert len(inside) == L
    else:
        assert not fence


def test_recompute_inside_a_ranged_backward_node():
    """A checkpointed function under the fence whose last saving op is
    ranged (an ``index_select``, as the combine's), its forward and its
    backward each on a fresh thread, as autograd runs a card's backward on
    the device's thread: the recompute runs inside that op's backward
    node, and sequence numbers count per thread, so the recompute's ranged
    ``index_select`` has the number of the forward's plain GEMM before it.
    Only the ranged op's own kernels (its forward, its recompute, and its
    backward's ``index_add_``) join the range's group; every GEMM, the
    recompute's and the backward's, stays a GEMM."""
    import threading

    g = torch.Generator().manual_seed(0)
    w0, w1, w2 = (torch.randn(8, 8, generator=g, requires_grad=True)
                  for _ in range(3))
    idx = torch.tensor([0, 1, 1, 3])
    combine = _trace.ranged(lambda h: h.index_select(0, idx), "toy::combine")

    def body(a):
        return combine(torch.relu(a @ w1) @ w2)

    x = torch.randn(4, 8, generator=g)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=every_thread) as prof:
        loss = []

        def forward():
            y = torch.utils.checkpoint.checkpoint(
                _trace.ranged(body, trace_train.FENCE), x @ w0, use_reentrant=False)
            loss.append(y.square().sum())
        for run in (forward, lambda: loss[0].backward()):
            thread = threading.Thread(target=run)
            thread.start()
            thread.join()
    events = prof.events()
    ops = ("aten::mm", "aten::index_select", "aten::index_add_")
    stand_in = {}

    def launched(ev):
        if ev.name in ops and id(ev) not in stand_in:
            stand_in[id(ev)] = [Kernel(("gemm " if ev.name == "aten::mm" else "")
                                       + ev.name, 1.0)]
        return stand_in.get(id(ev), [])
    fences = [ev for ev in events if ev.name == trace_train.FENCE]
    assert [ev.cpu_parent.name for ev in fences if ev.cpu_parent] == ["IndexSelectBackward0"]
    assert len({ev.thread for ev in fences}) == 2
    taken = _trace.attribute(
        events, {"toy::combine": "MoE dispatch", trace_train.FENCE: None},
        trace_train.MOVED_FROM, trace_train._group, launched)
    moved = sorted(k.name for ev in events for k in launched(ev) if id(k) in taken)
    assert moved == ["aten::index_add_", "aten::index_select", "aten::index_select"]
    assert {to for _, to, _ in taken.values()} == {"MoE dispatch"}

"""Port parity, the mesh, the sharding plan and the elastic rescale
(``launch/mesh.py``, ``core/mapping.py``, ``runtime/elastic.py``,
``checkpoint/ckpt.py:restore(shardings=)``, ``launch/train.py --mesh``).

The JAX package's ``sharding_plan`` and ``validate_rescale`` read only a
mesh's ``axis_names`` and ``devices.shape``, so they run in process on a
duck mesh (``types.SimpleNamespace(axis_names=..., devices=np.empty(shape))``)
and on the port's ``Mesh``: no fake devices, no subprocess.  Plans come
from shapes only: JAX's ``eval_shape`` trees, the port's meta tensors.  The
port keeps a list of per-layer trees where JAX stacks ``[L, ...]`` (``[G,
K, ...]`` for the hybrid's groups), so a port leaf's spec is held equal to
JAX's with the leading stack entries dropped, spec for spec, and the notes
note for note, for every config of ``ARCHS`` x {``TRAIN_4K``,
``DECODE_32K`` with its decode state, the same with ``decode_seq_shard``,
``LONG_500K`` where the config allows it} x four meshes."""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS, DECODE_32K, LONG_500K, TRAIN_4K  # noqa: E402
from repro.configs import get_config, shape_applicable  # noqa: E402
from repro.core import mapping as JMAP  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import elastic as JEL  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import restore, save  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import mapping as TMAP  # noqa: E402
from repro_torch.core.mapping import P, NamedSharding  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime import elastic as TEL  # noqa: E402

MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _duck(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p, simple=True, separator="."), x)
            for p, x in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]]


def _cases(cfg):
    """(shape, with its decode state, decode_seq_shard) for a config."""
    out = [(TRAIN_4K, False, False), (DECODE_32K, True, False),
           (DECODE_32K, True, True)]
    if shape_applicable(cfg, LONG_500K)[0]:
        out.append((LONG_500K, True, False))
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """JAX's and the port's parameter and decode-state shapes (eval_shape
    and meta tensors: nothing allocated), once per module."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    states = {}
    for shape, st, _ in _cases(cfg):
        if st and shape.name not in states:
            states[shape.name] = (
                jax.eval_shape(lambda s=shape: JM.init_decode_state(
                    cfg, s.global_batch, s.seq_len)),
                TM.init_decode_state(tcfg, shape.global_batch, shape.seq_len,
                                     device="meta"))
    return (cfg, tcfg, JS.init_state_shaped(cfg).params,
            TM.init_params(tcfg, device="meta"), states)


def _hold_params(tparams, tspecs, jspecs):
    """Every port leaf's spec is JAX's spec of the stacked leaf with the
    leading stack entries dropped; the port's leaves are JAX's, stacked."""
    want = dict(_jax_leaves(jspecs))
    seen = set()
    for (path, spec), (_, leaf) in zip(T.leaves_with_paths(tspecs, sep="."),
                                       T.leaves_with_paths(tparams, sep=".")):
        parts = path.split(".")
        jpath = ".".join(p for p in parts if not p.isdigit())
        n_stack = sum(p.isdigit() for p in parts)
        assert isinstance(spec, TMAP.PartitionSpec), path
        assert tuple(spec) == tuple(want[jpath])[n_stack:], (path, spec, want[jpath])
        seen.add(jpath)
    assert seen == set(want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_plan_matches_jax(arch, mesh_name):
    cfg, tcfg, jparams, tparams, states = _shapes(arch)
    shape_, names = MESHES[mesh_name]
    mesh = TMESH.Mesh(shape_, names, device="cpu")
    for shape, st, dss in _cases(cfg):
        js, ts = states[shape.name] if st else (None, None)
        want = JMAP.sharding_plan(cfg, _duck(shape_, names), shape,
                                  params_shape=jparams, state_shape=js,
                                  decode_seq_shard=dss)
        got = TMAP.sharding_plan(tcfg, mesh, shape, params_shape=tparams,
                                 state_shape=ts, decode_seq_shard=dss)
        tag = (shape.name, dss)
        _hold_params(tparams, got.params, want.params)
        assert got.notes == want.notes, tag
        assert tuple(got.batch_spec) == tuple(want.batch_spec), tag
        assert tuple(got.embeds_spec) == tuple(want.embeds_spec), tag
        assert (got.dp_axes, got.tp_axis, got.fsdp_axis) == \
            (want.dp_axes, want.tp_axis, want.fsdp_axis), tag
        if st:
            assert [(p, tuple(s)) for p, s in T.leaves_with_paths(got.state_specs, sep=".")] \
                == [(p, tuple(s)) for p, s in _jax_leaves(want.state_specs)], tag
        # every spec divides its leaf (JAX's NamedSharding.shard_shape check)
        for tree, specs in ((tparams, got.params), (ts, got.state_specs)):
            if specs is None:
                continue
            for leaf, sh in zip(T.leaves(tree), T.leaves(
                    TMAP.named_shardings(specs, mesh))):
                shard = sh.shard_shape(leaf.shape)
                assert all(a % b == 0 for a, b in zip(leaf.shape, shard))


def test_sharding_plan_notes_an_unmatched_stacked_leaf_once():
    """An unmatched path is replicated and noted once per stacked leaf, as
    JAX notes its one ``[L, ...]`` leaf; a rule never depends on the layer
    index, and FSDP never lands on a stack dim."""
    cfg, tcfg = get_config("stablelm-1.6b"), t_get_config("stablelm-1.6b")
    jtree = {"layers": {"extra": jax.ShapeDtypeStruct((3, 8, 6), jnp.float32),
                        "attn": {"wq": {"w": jax.ShapeDtypeStruct((3, 8, 16), jnp.float32)}}},
             "zz": jax.ShapeDtypeStruct((4,), jnp.float32)}
    ttree = {"layers": [{"extra": torch.empty(8, 6, device="meta"),
                         "attn": {"wq": {"w": torch.empty(8, 16, device="meta")}}}
                        for _ in range(3)],
             "zz": torch.empty(4, device="meta")}
    for mesh_name in ("4x2", "2x2x2"):
        shape_, names = MESHES[mesh_name]
        want = JMAP.sharding_plan(cfg, _duck(shape_, names), TRAIN_4K, params_shape=jtree)
        got = TMAP.sharding_plan(tcfg, TMESH.Mesh(shape_, names, "cpu"), TRAIN_4K,
                                 params_shape=ttree)
        assert got.notes == want.notes
        assert got.notes[:2] == ["unmatched param path replicated: layers.extra",
                                 "unmatched param path replicated: zz"]
        _hold_params(ttree, got.params, want.params)
        assert tuple(got.params["layers"][2]["attn"]["wq"]["w"]) == ("data", "model")


def test_partition_spec_and_named_sharding():
    assert P(("data",), None) == ("data", None) == tuple(JP(("data",), None))
    assert P(("pod", "data"), None) == (("pod", "data"), None)
    assert P() == () and P() != P(None) and len(P(None, "model")) == 2
    assert repr(P("model")) == "P('model')"
    mesh = TMESH.Mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    sh = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert sh.shard_shape((8, 3, 6, 5)) == (2, 3, 3, 5)
    assert sh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((6, 3, 6))
    with pytest.raises(ValueError, match="rank"):
        NamedSharding(mesh, P(None, None)).shard_shape((4,))
    with pytest.raises(ValueError, match="not one of"):
        NamedSharding(mesh, P("expert"))
    with pytest.raises(ValueError, match="used twice"):
        NamedSharding(mesh, P("data", ("pod", "data")))
    shs = TMAP.named_shardings({"a": P("data"), "b": [P(), None]}, mesh)
    assert shs["a"].spec == ("data",) and shs["b"][0].spec == () and shs["b"][1] is None


def test_meshes():
    for multi, shape, names in ((False, (16, 16), ("data", "model")),
                                (True, (2, 16, 16), ("pod", "data", "model"))):
        m = TMESH.make_production_mesh(multi_pod=multi)
        assert m.axis_names == names and m.devices.shape == shape
        assert m.device == torch.device("cuda")          # names the card; touches nothing
        assert TMESH.chips(m) == JMESH.chips(m) == (512 if multi else 256)
        assert m.axis_sizes == shape and TMESH.axis_sizes(m) == dict(zip(names, shape))
    t = TMESH.make_test_mesh(2, 4, device="cpu")
    assert (t.axis_names, t.axis_sizes) == (("data", "model"), (2, 4))
    t = TMESH.make_test_mesh(2, 2, n_pod=2, device="cpu")
    assert (t.axis_names, TMESH.chips(t)) == (("pod", "data", "model"), 8)
    for bad in (((2,), ("a", "b")), ((2, 2), ("a", "a")), ((0,), ("a",))):
        with pytest.raises(ValueError):
            TMESH.Mesh(*bad)


RESCALES = {   # name -> (old mesh, new mesh, global batch)
    "same": (((4, 2), ("data", "model")), ((4, 2), ("data", "model")), 256),
    "same_odd_batch": (((4, 2), ("data", "model")), ((4, 2), ("data", "model")), 255),
    "tp_changed": (((4, 2), ("data", "model")), ((2, 4), ("data", "model")), 256),
    "tp_changed_odd_batch": (((4, 2), ("data", "model")), ((2, 4), ("data", "model")), 6),
    "add_pods": (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), 256),
    "add_pods_batch_48": (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), 48),
    "drop_model_axis": (((4, 2), ("data", "model")), ((8,), ("data",)), 8),
    "pods_only": (((2, 2, 2), ("pod", "data", "model")), ((4,), ("pod",)), 2),
}


@pytest.mark.parametrize("case", sorted(RESCALES))
def test_validate_rescale_matches_jax(case):
    old, new, batch = RESCALES[case]
    want = JEL.validate_rescale(_duck(*old), _duck(*new), global_batch=batch)
    got = TEL.validate_rescale(TMESH.Mesh(*old, device="cpu"),
                               TMESH.Mesh(*new, device="cpu"), global_batch=batch)
    assert got == want
    assert bool(got) == (case not in ("same", "add_pods"))


def _tree(rng):
    return {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32)).to(torch.bfloat16),
            "layers": [{"n": torch.arange(6, dtype=torch.int32) + i} for i in range(2)]}


def test_rescale_from_checkpoint_round_trip(tmp_path):
    """Save on one mesh's plan, restore onto another's: bit-equal, each leaf
    on the new mesh's device; a spec that does not divide raises; no
    checkpoint raises as the reference's does."""
    tree = _tree(np.random.default_rng(3))
    save(str(tmp_path), 3, tree)
    mesh = TMESH.Mesh((2, 4), ("data", "model"), "cpu")
    specs = {"w": P("data", "model"), "b": P("model"),
             "layers": [{"n": P("data")}, {"n": P()}]}
    target = T.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)
    step, back = TEL.rescale_from_checkpoint(str(tmp_path), target,
                                             TMAP.named_shardings(specs, mesh))
    assert step == 3
    for a, b in zip(T.leaves(back), T.leaves(tree)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert a.view(torch.uint8).equal(b.view(torch.uint8)) if a.dtype != torch.int32 \
            else torch.equal(a, b)
    bad = dict(specs, b=P(("data", "model")))            # 8 over 8 divides; 8 over 16 not
    with pytest.raises(ValueError, match="does not divide"):
        TEL.rescale_from_checkpoint(str(tmp_path), target, TMAP.named_shardings(
            dict(bad, w=P(None, ("data", "model"))), TMESH.Mesh((4, 4), ("data", "model"), "cpu")))
    with pytest.raises(FileNotFoundError):
        TEL.rescale_from_checkpoint(str(tmp_path / "none"), target, None)
    moved = TEL.reshard_tree(tree, TMAP.named_shardings(specs, mesh))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(moved), T.leaves(tree)))


def test_restore_with_partial_shardings(tmp_path):
    """``restore(shardings=)`` places the leaves it names; the others land
    on their target leaf's device; a mismatched shape still raises."""
    tree = _tree(np.random.default_rng(4))
    save(str(tmp_path), 1, tree)
    mesh = TMESH.Mesh((2,), ("data",), "cpu")
    back = restore(str(tmp_path), 1, tree,
                   shardings={"w": NamedSharding(mesh, P("data")), "b": None})
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(back), T.leaves(tree)))
    with pytest.raises(ValueError, match="does not divide"):
        restore(str(tmp_path), 1, tree, shardings={
            "layers": [{"n": NamedSharding(TMESH.Mesh((4,), ("data",), "cpu"), P("data"))},
                       {"n": None}]})
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 1, dict(tree, w=torch.zeros(4, 4)))


@pytest.mark.parametrize("flags,exc,match", [
    (["--mesh", "single"], RuntimeError, r"chips\(mesh\) = 256"),
    (["--mesh", "multi"], RuntimeError, r"chips\(mesh\) = 512"),
    (["--distributed"], NotImplementedError, "one process"),
])
def test_launch_train_mesh_flags_raise(flags, exc, match):
    with pytest.raises(exc, match=match):
        tlaunch.main(["--reduced", "--device", "cpu", "--steps", "1", *flags])

"""Mapping: the paper's §3.3 output-split vs input-split analysis, realized
as the partition of every parameter, batch and decode-state dim over a
device mesh, with a bytes-moved cost model (a copy of the JAX package's
``core/mapping.py``).

Paper findings it reproduces:
  * DRAM-PIM prefers **output-split** (no inter-bank reduction, but the
    input vector must be broadcast and per-bank FC shapes become extremely
    imbalanced: long inputs, short outputs);
  * with an efficient inter-bank reduction (CompAir-NoC), **input-split**
    often wins because balanced shapes minimize data movement for a fixed
    MAC budget (mean-value inequality);
  * the classic Megatron FFN pairing (up/gate output-split + down
    input-split, one reduction per block) is exactly this theorem applied
    twice, and is the plan's default.

``choose_fc_split`` is the quantitative rule; ``sharding_plan`` applies it
across a model's parameter tree (with divisibility fallbacks so reduced
configs shard trivially), plus batch and cache/state specs, over a mesh
of ``launch/mesh.py`` (or the JAX package's).  A spec is a
``PartitionSpec``: one entry per leading dim, ``None``, an axis name or a
tuple of axis names.  The JAX package stacks a layer leaf ``[L, ...]``
(the hybrid's groups ``[G, K, ...]``) where the port keeps a list of
per-layer trees; every rule splits trailing dims only, so a port leaf's
spec is the reference's with its leading stack entries (all ``None``)
dropped.  ``named_shardings`` gives each spec its ``NamedSharding``,
whose ``shard_shape`` refuses a dim that does not divide and whose
``put`` places a tensor on the mesh's device.  Plans are made from shapes:
tensors on ``device="meta"`` (``models/model.py:init_params``) or any
leaves with a ``shape``.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.planner import H100, HWParams
from repro_torch.launch.mesh import axis_sizes as _mesh_axis_sizes


@dataclass(frozen=True)
class SplitChoice:
    split: str            # 'output' | 'input'
    comm_bytes: float     # per-device collective payload
    alt_bytes: float      # the rejected option's payload
    collective: str       # which collective it implies


def choose_fc_split(m: int, k: int, n: int, tp: int,
                    dtype_bytes: int = 2, input_sharded: bool = False,
                    hw: HWParams = H100) -> SplitChoice:
    """Cost of sharding an [m,k]@[k,n] FC over ``tp`` devices.

    output-split: W columns sharded; requires the activation replicated
        (all-gather m*k if it arrives reduce-scattered), output stays local.
    input-split:  W rows sharded; activation arrives k-sharded for free,
        partial [m,n] outputs need an all-reduce (2x ring payload).
    ``hw`` is unused, as in the reference: the rule compares bytes only.
    """
    frac = (tp - 1) / tp
    ag = m * k * dtype_bytes * frac if input_sharded else 0.0
    out_bytes = ag
    in_bytes = 2.0 * m * n * dtype_bytes * frac
    if in_bytes < out_bytes:
        return SplitChoice("input", in_bytes, out_bytes, "all-reduce")
    return SplitChoice("output", out_bytes, in_bytes, "all-gather")


def megatron_block_bytes(m: int, d: int, ff: int, tp: int,
                         dtype_bytes: int = 2) -> Dict[str, float]:
    """Fig. 8-style comparison: pure output-split vs the mixed mapping for
    a SwiGLU FFN block (per device, bytes moved)."""
    frac = (tp - 1) / tp
    # pure output-split: all three FCs column-sharded; activations must be
    # re-gathered between up/gate and down (down's input is ff-wide)
    pure_output = (m * d * dtype_bytes * frac          # gather x for up/gate
                   + m * ff * dtype_bytes * frac)      # gather h for down
    # mixed (paper/Megatron): up/gate output-split, down input-split:
    # one all-reduce of the [m, d] output
    mixed = 2.0 * m * d * dtype_bytes * frac
    return {"pure_output_split": pure_output, "mixed_input_split": mixed,
            "speedup": pure_output / max(mixed, 1.0)}


# ---------------------------------------------------------------------------
# partition specs and shardings over a mesh
# ---------------------------------------------------------------------------

def _entry(e):
    """A spec entry: None, an axis name, or a tuple of two or more names (a
    one-name tuple is that name, as JAX's ``PartitionSpec`` normalizes it)."""
    if e is None or isinstance(e, str):
        return e
    names = tuple(e)
    if not all(isinstance(n, str) for n in names):
        raise TypeError(f"a spec entry holds axis names, got {e!r}")
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def _names(e) -> Tuple[str, ...]:
    return () if e is None else ((e,) if isinstance(e, str) else e)


class PartitionSpec:
    """How an array's dims split over mesh axes: one entry per leading dim
    (``None``: not split; a name: split over that axis; a tuple of names:
    over their product, the first outermost); dims past the last entry are
    not split.  Equal to another spec or a tuple with the same entries.  Not
    a tuple itself, so ``repro_torch.tree`` takes a spec for one leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return isinstance(other, tuple) and self._entries == other

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}" if len(self) != 1 else f"P({self._entries[0]!r})"


P = PartitionSpec


class NamedSharding:
    """A spec over a mesh: which slice of an array each shard view holds.
    Every axis the spec names must be the mesh's, and each at most once."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        sizes, used = _mesh_axis_sizes(mesh), set()
        for e in self.spec:
            for name in _names(e):
                if name not in sizes:
                    raise ValueError(f"{self.spec}: axis {name!r} is not one of the "
                                     f"mesh's {tuple(sizes)}")
                if name in used:
                    raise ValueError(f"{self.spec}: axis {name!r} used twice")
                used.add(name)

    @property
    def device(self):
        return self.mesh.device

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one shard of an array of ``shape``; raises where a
        split dim does not divide by its shard count."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has {len(self.spec)} entries for an "
                             f"array of rank {len(shape)}")
        sizes, out = _mesh_axis_sizes(self.mesh), list(shape)
        for i, e in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _names(e))
            if out[i] % n:
                raise ValueError(f"{self.spec}: dim {i} of {shape} does not divide "
                                 f"into {n} shards over {e!r}")
            out[i] //= n
        return tuple(out)

    def put(self, x):
        """``x`` on the mesh's device, once its shape is known to divide."""
        self.shard_shape(x.shape)
        return x.to(self.device)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


# ---------------------------------------------------------------------------
# sharding plan
# ---------------------------------------------------------------------------

@dataclass
class Plan:
    """All PartitionSpecs for one (arch × shape × mesh) cell."""
    params: Optional[dict]            # tree matching params
    batch_spec: PartitionSpec         # for [B, S] token arrays
    embeds_spec: PartitionSpec        # for [B, S, d] stub embeddings
    state_specs: Optional[dict]       # decode cache/state tree specs
    dp_axes: Tuple[str, ...]
    tp_axis: str
    fsdp_axis: Optional[str] = None
    notes: List[str] = field(default_factory=list)


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _first_fit(shape, candidates, axis_sizes, taken=()):
    """candidates: list of (dim_index, axis_name). Returns a P(...) that
    assigns the first divisible candidate per dim (axes used once)."""
    spec = [None] * len(shape)
    used = set(taken)
    for dim, axis in candidates:
        if axis in used or dim >= len(shape) or spec[dim] is not None:
            continue
        if _divides(shape[dim], axis_sizes.get(axis, 0)):
            spec[dim] = axis
            used.add(axis)
    return P(*spec)


_PARAM_RULES: Sequence[Tuple[str, str]] = (
    # (path regex, rule name);  first match wins
    (r"embed.*table", "vocab_row"),
    (r"lm_head.*w$", "col"),
    (r"lm_head.*b$", "col_bias"),
    (r"(wq|wk|wv|gate|up)\.w$", "col"),
    (r"(wq|wk|wv|gate|up)\.b$", "col_bias"),
    (r"(wo|down|out_proj)\.w$", "row"),
    (r"(wo|down|out_proj)\.b$", "rep"),
    (r"moe.*router", "rep"),
    (r"moe.*w_(gate|up)$", "expert_col"),
    (r"moe.*w_down$", "expert_row"),
    (r"in_proj\.w$", "col"),
    (r"in_proj\.b$", "col_bias"),
    (r"conv_w$", "conv"),
    (r"(A_log|D|dt_bias)$", "rep"),
    (r"tm\.(wr|wk|wv|wg)\.w$", "col"),
    (r"tm\.wo\.w$", "row"),
    (r"cm\.wk\.w$", "col"),
    (r"cm\.wv\.w$", "row"),
    (r"cm\.wr\.w$", "col"),
    (r"(w_a|w_b|w0|mix|u)$", "rep"),
    (r"(ln|ln1|ln2|norm|final_norm).*scale$", "rep"),
)


def _param_spec(rule: str, shape, axis_sizes: Dict[str, int], fsdp_axis):
    """Trailing-2D semantic rules on the stacked shape; leading stack dims
    stay whole (FSDP lands on a feature dim instead)."""
    nd = len(shape)
    if rule == "rep":
        return P()
    if rule in ("col", "vocab_row", "row", "expert_col", "expert_row"):
        if rule == "vocab_row":
            cands = [(nd - 2, "model"), (nd - 1, fsdp_axis)]
        elif rule == "col":
            cands = [(nd - 1, "model"), (nd - 2, fsdp_axis)]
        elif rule == "row":
            cands = [(nd - 2, "model"), (nd - 1, fsdp_axis)]
        elif rule == "expert_col":   # [*, E, din, dout]
            cands = [(nd - 3, "model"), (nd - 1, fsdp_axis)]
        else:                        # expert_row [*, E, din, dout]
            cands = [(nd - 3, "model"), (nd - 2, fsdp_axis)]
        return _first_fit(shape, [c for c in cands if c[1]], axis_sizes)
    if rule in ("col_bias", "conv"):  # [*, d_out] / [*, W, channels]
        return _first_fit(shape, [(nd - 1, "model")], axis_sizes)
    raise ValueError(rule)


def _rule(path: str) -> Optional[str]:
    for rx, rule in _PARAM_RULES:
        if re.search(rx, path):
            return rule
    return None


def _param_specs(params, axis_sizes, fsdp_axis, notes):
    """The spec of every leaf of the port's parameter tree.  A list is a
    layer stack (the reference's leading ``[L]``, or ``[G, K]`` for a list
    of lists): its index leaves the rule's path and its length joins the
    leaf's shape, and the stack's entries leave the spec again.  Leaves are
    visited in the reference's order; an unmatched path is noted once per
    stacked leaf (at every stack index 0), as the reference notes it."""

    def walk(t, path, stack, first):
        if isinstance(t, dict):
            built = {k: walk(t[k], path + (str(k),), stack, first) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path, stack + (len(t),), first and i == 0)
                           for i, v in enumerate(t))
        pstr = ".".join(path)
        rule = _rule(pstr)
        if rule is None:
            if first:
                notes.append(f"unmatched param path replicated: {pstr}")
            return P()
        spec = tuple(_param_spec(rule, stack + tuple(t.shape), axis_sizes, fsdp_axis))
        if any(e is not None for e in spec[:len(stack)]):
            raise ValueError(f"{pstr}: {spec} splits a layer-stack dim")
        return P(*spec[len(stack):])

    return walk(params, (), (), True)


def sharding_plan(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                  params_shape=None, state_shape=None,
                  fsdp: Optional[bool] = None,
                  decode_seq_shard: bool = False) -> Plan:
    """Build all PartitionSpecs for a cell.

    mesh: axes ('data','model') or ('pod','data','model') (``launch/mesh.py``).
    params_shape: the port's parameter tree (shapes only are read).
    state_shape: a decode state of ``models/model.py:init_decode_state``.
    fsdp: shard params over the data axis too (default: only for train).
    """
    axis_sizes = _mesh_axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    if fsdp is None:
        fsdp = shape.kind == "train"
    fsdp_axis = "data" if (fsdp and "data" in axis_sizes) else None
    notes: List[str] = []

    # ---- params ----
    param_specs = None
    if params_shape is not None:
        param_specs = _param_specs(params_shape, axis_sizes, fsdp_axis, notes)

    # ---- batch ----
    b = shape.global_batch
    # use the largest prefix of dp axes that divides the batch
    chosen: List[str] = []
    prod = 1
    for a in dp_axes:
        if b % (prod * axis_sizes[a]) == 0:
            chosen.append(a)
            prod *= axis_sizes[a]
    if not chosen:
        notes.append(f"batch={b} unsharded (does not divide dp axes)")
    batch_spec = P(tuple(chosen) if chosen else None, None)
    embeds_spec = P(tuple(chosen) if chosen else None, None, None)

    # ---- decode cache / state ----
    state_specs = None
    if state_shape is not None:
        seq_shard = shape.name == "long_500k"

        def cache_spec(pstr, leaf):
            shp = tuple(leaf.shape)
            nd = len(shp)
            if re.search(r"attn\.(k|v)$", pstr):
                # [slots, B, S, KvH, hd]
                spec = [None] * nd
                if chosen and _divides(shp[nd - 4], prod):
                    spec[nd - 4] = tuple(chosen)
                if decode_seq_shard and _divides(shp[nd - 3],
                                                 axis_sizes.get("model", 0)):
                    # sequence-sharded cache over the TP axis; flash-decoding
                    # partials combined by the NoC tree softmax (paper Fig. 10)
                    spec[nd - 3] = "model"
                    notes.append("KV cache sequence-sharded over 'model'; "
                                 "NoC tree-softmax combine")
                    return P(*spec)
                if seq_shard and _divides(shp[nd - 3], axis_sizes.get("data", 0)):
                    spec[nd - 3] = "data"
                    notes.append("KV cache sequence-sharded over 'data' "
                                 "(long_500k): partials combined via NoC tree softmax")
                if _divides(shp[nd - 2], axis_sizes.get("model", 0)):
                    spec[nd - 2] = "model"
                elif _divides(shp[nd - 1], axis_sizes.get("model", 0)):
                    spec[nd - 1] = "model"   # paper input-split: shard head_dim
                    notes.append("KV heads < TP: head_dim (contraction) sharded "
                                 "= paper input-split mapping")
                return P(*spec)
            # generic states: [L(, K), B, ...trailing feature dims]
            spec = [None] * nd
            # the batch dim: the first dim equal to the global batch
            for i, s in enumerate(shp):
                if s == b and chosen and _divides(s, prod):
                    spec[i] = tuple(chosen)
                    break
            # shard the largest trailing dim on model if divisible
            best = None
            for i in range(nd - 1, max(nd - 3, 0), -1):
                if spec[i] is None and _divides(shp[i], axis_sizes.get("model", 0)):
                    if best is None or shp[i] > shp[best]:
                        best = i
            if best is not None:
                spec[best] = "model"
            return P(*spec)

        state_specs = T.unflatten(state_shape, [
            cache_spec(pstr, leaf)
            for pstr, leaf in T.leaves_with_paths(state_shape, sep=".")])

    return Plan(params=param_specs, batch_spec=batch_spec,
                embeds_spec=embeds_spec, state_specs=state_specs,
                dp_axes=dp_axes, tp_axis="model", fsdp_axis=fsdp_axis,
                notes=notes)


def named_shardings(plan_tree, mesh):
    """Each spec of a plan tree as its ``NamedSharding`` on ``mesh``."""
    return T.map(lambda spec: None if spec is None else NamedSharding(mesh, spec),
                 plan_tree)
